"""Query-processor sessions: SQL in, results out.

The compact analog of the reference's KQP session path (SURVEY.md §3.2):
gRPC request → session actor → compile (cached) → execute. Here:

  * ``Cluster`` owns storage (blob store + coordinator + sharded tables)
    and the schema catalog — the in-process stand-in for a node's service
    set; the PostgreSQL wire front (``api/pgwire.py``) serves it
  * ``Session.execute(sql)`` parses, consults the per-cluster plan cache
    (keyed on SQL text — the compile-service LRU shape,
    kqp_compile_service.cpp), plans against the catalog, and runs the
    plan executor at a consistent read snapshot

DDL (CREATE TABLE) and DML (INSERT, UPDATE, DELETE) execute directly
against the state plane with coordinated commits; BEGIN / COMMIT /
ROLLBACK buffer row-table writes and commit them as one volatile
distributed transaction.

The port's own copy of ``ydb_tpu/kqp/session.py``, for column and row
tables (``WITH (store = row)``, ``datashard/``). ``Cluster(device=)``
(CUDA unless the caller names another device) hands its device to every
column shard, to its ``DeviceBlockCache`` and to each statement's
``Database``. The store layout is the reference's (scheme tablet,
dictionary journal, column and row shard WALs, plan-step clock,
statistics snapshot), so a ``Cluster`` of either package boots from a
store the other wrote. A statement builds a row table's
``ColumnSource`` (``RowTable.source_at``) only when it reads that table,
at the statement's one snapshot; the reference builds every row table's
on every statement (off its mesh path). A statement's device work
(``execute_plan``, ``to_host``, a batch's dispatch) holds
``device.work_lock`` shared, so a CUDA graph capture on another thread
never overlaps it; row DML takes its shard locks before it.

Sys views (``obs/sysview.py``, gated on ``enable_sys_views``) build
lazily inside the statement's ``_RowSources``: a statement that reads no
sys view builds none. ``Cluster.quoter`` (``runtime/quoter.py``), when
set, gates every statement on the ``kqp/requests`` bucket and raises
``ThrottledError``. ``CREATE`` / ``DROP SEQUENCE`` and ``nextval`` in
INSERT run over ``Cluster.sequences`` (``tablet/kesus.py``'s
``SequenceShard`` on the cluster's store, booted on first use).
``run_background`` shrinks a ``CachedBlobStore``'s budget when the
process's RSS nears ``memory_soft_limit_bytes``.

Left out, each for a later item of ROADMAP.md queue A, with a typed
``PlanError`` naming it where a statement reaches it: changefeeds and
topics (item 11; ``Cluster.topics`` stays empty); the mesh executor
(item 13).

Observability and chaos: the ``kqp.plan_cache`` probe fires per plan
lookup and ``query.slow`` once per statement past
YDB_TPU_TORCH_SLOW_QUERY_SECONDS (the watchdog rides
``run_background``); the ``session.admit`` chaos site sheds a statement
with ``OverloadedError``; ``run_background`` exports the conveyor queue
telemetry and the ``movement`` and ``chaos`` counter groups.
"""

from __future__ import annotations

import dataclasses
import json
import os
import threading
import time as _time
from collections import OrderedDict, deque

import numpy as np

from ydb_tpu_torch import chaos, dtypes
from ydb_tpu_torch.analysis import host_ok as _host_ok
from ydb_tpu_torch.analysis import leaksan as _leaksan
from ydb_tpu_torch.analysis import memsan as _memsan
from ydb_tpu_torch.analysis import sanitizer as _san
from ydb_tpu_torch.analysis import syncsan as _syncsan
from ydb_tpu_torch.blocks.dictionary import DictionarySet
from ydb_tpu_torch.device import resolve_device
from ydb_tpu_torch.engine.blobs import BlobStore, MemBlobStore
from ydb_tpu_torch.engine.oracle import OracleTable
from ydb_tpu_torch.obs.sysview import SYS_SCHEMAS, health_check, table_stats
from ydb_tpu_torch.plan import Database, execute_plan, to_host
from ydb_tpu_torch.sql import ast
from ydb_tpu_torch.sql.parser import parse
from ydb_tpu_torch.sql.planner import (
    Catalog,
    PlanError,
    plan_select,
    plan_select_full,
)
from ydb_tpu_torch.obs.probes import probe as _probe
from ydb_tpu_torch.tx import Coordinator, ShardedTable
from ydb_tpu_torch.tx.coordinator import TxResult

_P_PLAN_CACHE = _probe("kqp.plan_cache")
_P_SLOW = _probe("query.slow")

# conveyor queue-depth histogram buckets (task counts, not seconds)
_DEPTH_BOUNDS = (1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024)

#: what a statement that needs changefeeds is told
CHANGEFEEDS_LATER = ("the port has no changefeeds yet (ROADMAP.md queue A "
                     "item 11: streaming)")

_TYPE_MAP = {
    "int8": dtypes.INT8, "int16": dtypes.INT16, "int32": dtypes.INT32,
    "int": dtypes.INT32, "int64": dtypes.INT64, "bigint": dtypes.INT64,
    "uint64": dtypes.UINT64, "float": dtypes.FLOAT, "double": dtypes.DOUBLE,
    "bool": dtypes.BOOL, "date": dtypes.DATE, "timestamp": dtypes.TIMESTAMP,
    "string": dtypes.STRING, "utf8": dtypes.STRING, "text": dtypes.STRING,
    # Kind.value spellings, so scheme.model.type_to_str output
    # round-trips back through DDL (DescribeTable -> CreateTable)
    "uint8": dtypes.UINT8, "uint16": dtypes.UINT16,
    "uint32": dtypes.UINT32, "float32": dtypes.FLOAT,
    "float64": dtypes.DOUBLE,
}


def _parse_type(t: str) -> dtypes.LogicalType:
    t = t.lower()
    if t.startswith("decimal"):
        if "(" in t:
            args = t[t.index("(") + 1:].rstrip(")").split(",")
            # decimal(p) = scale 0 (SQL standard); decimal(p,s)
            s = int(args[1]) if len(args) == 2 else 0
        else:
            s = 0
        return dtypes.decimal(s)
    if t in _TYPE_MAP:
        return _TYPE_MAP[t]
    raise PlanError(f"unknown type {t}")


def _find_page_cache(store, depth: int = 4):
    """Locate a pressure-reactive page cache in a (possibly wrapped)
    store: walks common wrapper attributes (CachedBlobStore.base,
    tiered hot/cold, failpoint inner)."""
    if store is None or depth < 0:
        return None
    if hasattr(store, "react_to_pressure"):
        return store
    for attr in ("base", "hot", "cold", "inner", "store"):
        found = _find_page_cache(getattr(store, attr, None), depth - 1)
        if found is not None:
            return found
    return None


def _process_rss() -> int:
    """Current resident set size in bytes (Linux /proc; real page
    size). 0 when unreadable — pressure reaction then stays idle
    rather than acting on a lying number."""
    try:
        import resource

        with open("/proc/self/statm") as f:
            return (int(f.read().split()[1])
                    * resource.getpagesize())
    except OSError:
        return 0


def _release(values) -> None:
    """Free the CUDA graphs (and their private pools) of the fused plans
    among compile-cache values that left the cache."""
    from ydb_tpu_torch.ssa.plan_fuse import FusedPlan

    for v in values:
        if isinstance(v, FusedPlan):
            v.release()


class _BoundedCompileCache(dict):
    """LRU-bounded, lock-guarded dict for the cluster compile cache.

    Compiled entries pin device-resident aux tensors, and fused plans
    pin CUDA graphs with their memory pools; ad-hoc workloads mint a
    fresh key per distinct statement — an unbounded dict is a leak.
    Dict-compatible ``get`` / ``[]=`` so the plan executor and DQ stage
    compiler use it unchanged; the lock serializes the LRU bookkeeping
    against concurrent sessions. An entry that leaves (eviction or
    ``clear``) releases its graphs, after the lock is let go."""

    def __init__(self, capacity: int = 256):
        super().__init__()
        self.capacity = max(1, capacity)
        self._lock = threading.Lock()
        self._order: OrderedDict = OrderedDict()

    def get(self, key, default=None):
        with self._lock:
            if key in self._order:
                self._order.move_to_end(key)
            return dict.get(self, key, default)

    def __setitem__(self, key, value):
        gone = []
        with self._lock:
            old = dict.get(self, key)
            if old is not None and old is not value:
                gone.append(old)
            dict.__setitem__(self, key, value)
            self._order[key] = None
            self._order.move_to_end(key)
            while len(self._order) > self.capacity:
                k, _ = self._order.popitem(last=False)
                gone.append(dict.pop(self, k, None))
        _release(gone)

    def clear(self):
        with self._lock:
            gone = list(dict.values(self))
            dict.clear(self)
            self._order.clear()
        _release(gone)

    def pool_bytes(self) -> int:
        """Bytes held by the private pools of the cached fused plans'
        CUDA graphs (0 where a pool's size is unknown)."""
        from ydb_tpu_torch.ssa.plan_fuse import FusedPlan

        with self._lock:
            plans = [v for v in dict.values(self)
                     if isinstance(v, FusedPlan)]
        return sum(p.pool_bytes or 0 for p in plans)


class Cluster:
    """Storage + schema tablet + plan cache: one in-process database.

    The schema catalog is a real SchemeShard (``scheme/shard.py``) over
    a tablet executor on the same blob store as the data shards, so the
    entire database — schema AND data — reboots from the store alone:
    ``Cluster(store=same_store)`` after process death recovers every
    table. String dictionaries are cluster-shared (ids must agree across
    tables for joins), so their growth is journaled cluster-wide and
    replayed before any shard boots.
    """

    def __init__(
        self,
        store: BlobStore | None = None,
        n_shards: int | None = None,
        plan_cache_size: int | None = None,
        config=None,
        device=None,
    ):
        from ydb_tpu_torch.config import AppConfig, ControlBoard
        from ydb_tpu_torch.engine.blockcache import DeviceBlockCache
        from ydb_tpu_torch.kqp.batch import BatchDispatcher
        from ydb_tpu_torch.obs.counters import CounterGroup
        from ydb_tpu_torch.obs.metering import Metering
        from ydb_tpu_torch.obs.profile import ProfileRing
        from ydb_tpu_torch.obs.tracing import Tracer
        from ydb_tpu_torch.scheme.shard import SchemeShardCore
        from ydb_tpu_torch.stats.aggregator import StatisticsAggregator
        from ydb_tpu_torch.tablet.executor import TabletExecutor

        #: where every shard scans, the block cache holds its blocks and
        #: every statement runs (raises here without a GPU unless the
        #: caller names the CPU)
        self.device = resolve_device(device)
        self.config = config if config is not None else AppConfig()
        self.flags = self.config.feature_flags
        self.store = store if store is not None else MemBlobStore()
        self.n_shards = (n_shards if n_shards is not None
                         else self.config.n_shards)
        self.tables: dict = {}  # name -> ShardedTable | RowTable
        # topics come with streaming (ROADMAP.md queue A item 11); the
        # viewer and tablet counters read this empty map until then
        self.topics: dict = {}
        #: every table's full primary key (the scheme's), for the planner
        self.primary_keys: dict[str, tuple] = {}
        self.counters = CounterGroup({"component": "kqp"})
        self.tracer = Tracer()
        self.query_log: deque = deque(maxlen=256)
        # audit trail of state-changing statements (audit log analog)
        self.audit_log: deque = deque(maxlen=1024)
        # optional request-unit quoter (runtime/quoter.py): when set,
        # every statement consumes 1 unit from "kqp/requests"
        self.quoter = None
        # usage metering: request units booked per statement
        self.metering = Metering()
        # optional admission planes (kqp rm_service/workload_service):
        # when set, every statement passes pool admission and books a
        # compute slot for its duration
        self.workload = None
        self.rm = None
        # multi-tenant front door (serving/admission.py): when
        # installed via serving.install(cluster), every statement
        # acquires a per-tenant admission seat before the workload
        # pool, and shedding happens per tenant instead of through the
        # global max_inflight_statements valve
        self.front_door = None
        # device block cache shared by every statement's scans (the
        # shared-page-cache analog; statement Databases are transient,
        # the cache is node-scoped)
        self.scan_block_cache = DeviceBlockCache(device=self.device)
        self._prune_stamp = None  # last pruned (shard, meta_gen) set
        # cross-query micro-batching dispatcher (kqp/batch.py): disarmed
        # unless YDB_TPU_TORCH_BATCH_WINDOW_MS > 0, in which case
        # compatible concurrent SELECTs share one fused device dispatch
        self.batcher = BatchDispatcher()
        self._query_seq = 0
        self._qid_lock = threading.Lock()
        # load-shedding limit on concurrently in-flight statements
        # (0 = unlimited): past it Session.execute fails fast with
        # OverloadedError instead of queueing unboundedly
        self.max_inflight_statements = int(
            os.environ.get("YDB_TPU_TORCH_MAX_INFLIGHT", "0") or 0)
        # registered scalar UDFs: name -> (vectorized fn, result type)
        self.udfs: dict[str, tuple] = {}
        # durable sequence allocator (tablet/kesus.py SequenceShard),
        # lazily booted on first CREATE SEQUENCE / nextval
        self._sequences = None
        # live-tunable knobs (immediate control board)
        self.icb = ControlBoard()
        self.icb.register("rmw_retries", 5, 1, 100)
        self.icb.register("compact_portion_threshold",
                          self.config.compact_portion_threshold, 2, 1024)
        self.icb.register("split_rows_per_shard",
                          self.config.split_rows_per_shard,
                          0, 1 << 40)
        self.dicts = DictionarySet()  # cluster-wide, shared by all tables
        # StatisticsAggregator: snapshot/restore rides a tablet executor
        # on the SAME blob store, so a rebooted node plans with
        # persisted statistics while the first refresh runs
        self.stats = StatisticsAggregator(store=self.store)
        self._plan_cache: OrderedDict = OrderedDict()
        self._plan_cache_size = (
            plan_cache_size if plan_cache_size is not None
            else self.config.plan_cache_size)
        # node-scoped compiled-program cache shared by every statement's
        # Database: a second run of the same SELECT reuses its compiled
        # programs and fused CUDA graphs (compile-cache hit/miss is a
        # per-query attribute). Invalidated with the plan cache (dict
        # growth bakes into aux); LRU-bounded.
        self._compile_cache: dict = _BoundedCompileCache()
        # bounded ring of recent query profiles feeding last_profile
        self.profiles = ProfileRing()
        # in-flight statement registry: token -> {sql, start, stage,
        # ...}; sessions register before admission and unregister in a
        # finally, so a failed statement always clears
        self._active_lock = _san.make_lock(f"kqp.{id(self):x}.active")
        self.active_queries = _san.share(
            {}, f"kqp.{id(self):x}.active_queries")
        self._active_seq = 0
        # leak-sanitizer handle per registry row (guarded by
        # _active_lock; kept OUT of the row dicts, which snapshot APIs
        # copy); empty whenever the sanitizer is off
        self._active_leaks: dict[int, object] = {}
        self.slow_queries = 0
        self._dict_seq = 0
        self._dict_durable: dict[str, int] = {}
        self._replay_dict_journal()
        self.scheme = SchemeShardCore(
            TabletExecutor.boot("schemeshard", self.store))
        # finish any DROP TABLE whose blob deletion a crash interrupted
        self._sweep_trash()
        # data shards boot before the coordinator so its plan-step clock
        # can resume past every snapshot the shards have seen
        self.coordinator = Coordinator()
        for desc in self.scheme.list_tables():
            self._instantiate(desc, boot=True)
        max_snap = max(
            (s.snap for t in self.tables.values() for s in t.shards),
            default=0,
        )
        # durable clock: plan-step reservations persist in the store, so
        # a coordinator reboot resumes past every step it may have issued
        # even if some shard never saw it
        self.coordinator = Coordinator(self.store, start_step=max_snap)
        for t in self.tables.values():
            t.coordinator = self.coordinator
            for s in t.shards:
                if hasattr(s, "snap_source"):
                    s.snap_source = self.coordinator.background_plan
        # finish any DROP COLUMN strip a crash interrupted (marker set
        # durably before the scheme alter committed); column tables read
        # dropped columns as absent by schema version
        for path in self.scheme.pending_strips():
            t = self.tables.get(path.strip("/"))
            if t is not None and hasattr(t, "post_boot_sweep"):
                t.post_boot_sweep()
            self.scheme.clear_strip(path)
        # sweep shard generations orphaned by a crash mid-reshard (the
        # scheme descriptor is the cutover truth; anything else is trash)
        for t in self.tables.values():
            t.sweep_stale_generations()

    def _invalidate_plans(self) -> None:
        """Drop cached plans AND compiled executors together: both bake
        dictionary contents / schema shape into plan-time state. Fused
        plans free their CUDA graphs as they leave."""
        self._plan_cache.clear()
        self._compile_cache.clear()

    def stop(self, timeout: float = 30.0) -> None:
        """Orderly node teardown: stop the statistics cadence thread,
        wait for queued background work (promotions, prefetch,
        compaction tasks) to drain off the shared conveyor, then — under
        YDB_TPU_TORCH_LEAKSAN — prove every tracked resource handle in
        the process drained to zero (:class:`~ydb_tpu_torch.analysis.
        leaksan.LeakError` names survivors). The drain check is
        process-global, so call it with no other cluster mid-statement
        (tests; single-node serving)."""
        self.stats.stop()
        from ydb_tpu_torch.runtime.conveyor import shared_conveyor

        shared_conveyor().wait_idle(timeout=timeout)
        _leaksan.assert_drained(where="Cluster.stop")

    # ---- dict durability (cluster-wide journal) ----

    def _replay_dict_journal(self) -> None:
        for blob_id in self.store.list("cluster/dicts/"):
            delta = json.loads(self.store.get(blob_id).decode())
            for col, values in delta.items():
                d = self.dicts.for_column(col)
                for v in values:
                    d.add(v.encode("latin1"))
            self._dict_seq += 1
        for col in self.dicts.columns():
            self._dict_durable[col] = len(self.dicts[col])

    def _journal_dicts(self) -> None:
        delta = {}
        for col in self.dicts.columns():
            d = self.dicts[col]
            n0 = self._dict_durable.get(col, 0)
            if len(d) > n0:
                delta[col] = [v.decode("latin1") for v in d.values[n0:]]
                self._dict_durable[col] = len(d)
        if delta:
            self.store.put(f"cluster/dicts/{self._dict_seq:010d}",
                           json.dumps(delta).encode())
            self._dict_seq += 1

    # ---- DDL / DML ----

    def _instantiate(self, desc, boot: bool = False):
        from ydb_tpu_torch.datashard.table import RowTable
        from ydb_tpu_torch.engine.shard import ShardConfig

        if desc.changefeed:
            raise PlanError(f"table {desc.path}: {CHANGEFEEDS_LATER}")
        shard_config = ShardConfig(
            compact_portion_threshold=self.config
            .compact_portion_threshold,
            checkpoint_interval=self.config.checkpoint_interval,
            scan_block_rows=self.config.scan_block_rows,
        )
        name = desc.path.strip("/")
        if desc.store == "row":
            t = RowTable(
                name, desc.schema, self.store, self.coordinator,
                n_shards=desc.n_shards,
                pk_columns=tuple(desc.primary_key),
                ttl_column=desc.ttl_column, dicts=self.dicts, boot=boot,
                gen=desc.shard_gen,
            )
        else:
            t = ShardedTable(
                name, desc.schema, self.store, self.coordinator,
                n_shards=desc.n_shards, pk_column=desc.primary_key[0],
                ttl_column=desc.ttl_column, dicts=self.dicts, boot=boot,
                config=shard_config, upsert=desc.upsert,
                gen=desc.shard_gen, device=self.device,
            )
        t.alter_schema(desc.schema, desc.schema_version, desc.column_added)
        # dict ids must be durable BEFORE any shard WAL references them:
        # a crash between the two would otherwise leave dangling ids
        t.pre_commit = self._journal_dicts
        self.tables[name] = t
        self.primary_keys[name] = tuple(desc.primary_key)
        return t

    def create_table(self, stmt: ast.CreateTable) -> None:
        from ydb_tpu_torch.scheme.model import TableDescription
        from ydb_tpu_torch.scheme.shard import SchemeError

        if stmt.table in self.tables:
            raise PlanError(f"table {stmt.table} already exists")
        if stmt.table.startswith("sys_"):
            # reserved: user tables must not shadow system views
            raise PlanError("the sys_ name prefix is reserved")
        fields = []
        for name, typ, not_null in stmt.columns:
            fields.append(dtypes.Field(name, _parse_type(typ), not not_null))
        schema = dtypes.Schema(tuple(fields))
        pk = stmt.primary_key or (fields[0].name,)
        opts = dict(stmt.options)
        unknown = set(opts) - {"shards", "store", "ttl_column",
                               "changefeed", "upsert"}
        if unknown:
            raise PlanError(f"unknown WITH option(s): {sorted(unknown)}")
        try:
            n_shards = int(opts.get("shards", self.n_shards))
        except ValueError:
            raise PlanError(f"WITH shards must be an integer, got "
                            f"{opts['shards']!r}") from None
        if n_shards < 1:
            raise PlanError("WITH shards must be >= 1")
        store_kind = opts.get("store", "column")
        if store_kind not in ("column", "row"):
            raise PlanError(f"WITH store must be column|row, "
                            f"got {store_kind!r}")
        if store_kind == "row" and not self.flags.enable_row_tables:
            raise PlanError("row tables are disabled by feature flag")
        if "ttl_column" in opts and opts["ttl_column"] not in schema:
            raise PlanError(f"ttl_column {opts['ttl_column']!r} not in "
                            f"schema")
        upsert = opts.get("upsert", "off") in ("on", "true", "1")
        if upsert and store_kind != "column":
            raise PlanError("upsert semantics apply to column tables"
                            " (row tables always upsert by PK)")
        changefeed = opts.get("changefeed", "off") in ("on", "true", "1")
        if changefeed and store_kind != "row":
            raise PlanError("changefeed requires a row-store table")
        if changefeed and not self.flags.enable_changefeeds:
            raise PlanError("changefeeds are disabled by feature flag")
        if changefeed:
            raise PlanError(f"WITH (changefeed = on): {CHANGEFEEDS_LATER}")
        desc = TableDescription(
            path="/" + stmt.table,
            schema=schema,
            primary_key=tuple(pk),
            n_shards=n_shards,
            store=store_kind,
            ttl_column=opts.get("ttl_column"),
            changefeed=False,
            upsert=upsert,
        )
        try:
            self.scheme.create_table(desc)
        except SchemeError as e:
            raise PlanError(str(e)) from e
        self._instantiate(desc)
        self._invalidate_plans()

    def drop_table(self, stmt: ast.DropTable) -> None:
        from ydb_tpu_torch.scheme.shard import SchemeError

        t = self.tables.get(stmt.table)
        prefixes = t.storage_prefixes() if t is not None else []
        try:
            # prefixes are recorded durably in the drop tx itself; the
            # boot sweep finishes deletion if we crash before it
            self.scheme.drop_table("/" + stmt.table,
                                   trash_prefixes=prefixes)
        except SchemeError as e:
            raise PlanError(str(e)) from e
        self.tables.pop(stmt.table, None)
        self.primary_keys.pop(stmt.table, None)
        self._sweep_trash()
        self.stats.forget(
            stmt.table, [sh.shard_id for sh in getattr(t, "shards", ())])
        self._invalidate_plans()
        # a re-created same-name table reuses shard ids AND restarts
        # portion ids at 1, so stale entries would collide with the new
        # table's keys and serve the dropped table's rows
        self.scan_block_cache.clear()
        # same portion-id-reuse hazard for the resident tier; the
        # dropped shards are unreachable, but free their device tensors
        # now rather than at GC
        for sh in getattr(t, "shards", ()):
            store = getattr(sh, "resident", None)
            if store is not None:
                store.clear()

    def _sweep_trash(self) -> None:
        for op_id, prefixes in self.scheme.trash():
            for prefix in prefixes:
                for blob_id in self.store.list(prefix):
                    self.store.delete(blob_id)
            self.scheme.clear_trash(op_id)

    def alter_table(self, stmt: ast.AlterTable) -> None:
        from ydb_tpu_torch.scheme.shard import SchemeError

        t = self.tables.get(stmt.table)
        if t is None:
            raise PlanError(f"unknown table {stmt.table}")
        add = [dtypes.Field(n, _parse_type(ty), True)
               for n, ty in stmt.add_columns]
        row_strip = stmt.drop_columns and hasattr(t, "post_boot_sweep")
        if row_strip:
            # marker precedes the schema commit: a crash anywhere before
            # clear_strip re-runs the strip on next boot
            self.scheme.mark_strip("/" + stmt.table)
        try:
            desc = self.scheme.alter_table(
                "/" + stmt.table, add_columns=add,
                drop_columns=list(stmt.drop_columns))
        except SchemeError as e:
            if row_strip:
                self.scheme.clear_strip("/" + stmt.table)
            raise PlanError(str(e)) from e
        t.alter_schema(desc.schema, desc.schema_version, desc.column_added)
        if row_strip:
            self.scheme.clear_strip("/" + stmt.table)
        self._invalidate_plans()

    def run_background(self) -> dict:
        """One maintenance pass: table compaction/TTL, statistics
        refresh, load-driven resharding and the counter export (the
        conveyor/background-task plane, driven by the hosting layer).
        ICB knobs apply here, so live tuning takes effect without a
        restart."""
        threshold = self.icb.get("compact_portion_threshold")
        stats = {"compacted": 0, "splits": 0, "merges": 0}
        for t in self.tables.values():
            for s in t.shards:
                if hasattr(s, "config"):
                    s.config.compact_portion_threshold = threshold
            # a row table compacts its shards' version chains here; its
            # TTL eviction needs a cutoff, which this pass does not give
            stats["compacted"] += t.run_background().get("compacted", 0)
        # statistics refresh rides the maintenance cadence; incremental
        # — only never-seen portions cost chunk reads. A failed refresh
        # never blocks maintenance: scans degrade to unpruned reads
        try:
            self.stats.refresh_cluster(self)
            stats["stats_tables"] = len(self.stats.all_stats())
        except Exception:  # noqa: BLE001 - stats are advisory
            pass
        self._auto_reshard(stats)
        # resident-tier aggregate counters
        res = {"bytes": 0, "portions": 0, "promotions": 0,
               "evictions": 0, "spills": 0, "hits": 0}
        have_res = False
        for t in self.tables.values():
            for s in t.shards:
                store = getattr(s, "resident", None)
                if store is None:
                    continue
                have_res = True
                snap = store.snapshot()
                for k in res:
                    res[k] += snap[k]
        if have_res:
            g = self.counters.group(component="resident")
            for k, v in res.items():
                g.counter(k).set(v)
            stats["resident_bytes"] = res["bytes"]
        # memory pressure: when the store is (or wraps) a shared page
        # cache, shrink its budget as process RSS approaches the soft
        # limit and restore it when pressure clears
        cache = _find_page_cache(self.store)
        limit = getattr(self.config, "memory_soft_limit_bytes", 0)
        rss = _process_rss()
        if cache is not None and limit and rss:
            stats["cache_pressure"] = cache.react_to_pressure(
                rss / limit)
        # conveyor queue telemetry: lifetime totals plus the depth
        # high-water mark and per-queue wait samples since the last pass
        from ydb_tpu_torch.runtime.conveyor import shared_conveyor

        qs = shared_conveyor().queue_stats()
        g = self.counters.group(component="conveyor")
        for k in ("submitted", "completed", "rejected", "depth",
                  "active", "workers", "max_depth"):
            g.counter(k).set(qs[k])
        g.histogram("queue_depth",
                    bounds=_DEPTH_BOUNDS).observe(float(qs["max_depth"]))
        for q, waits in qs["waits"].items():
            h = self.counters.group(
                component="conveyor", queue=q).histogram(
                    "queue_wait_seconds")
            for w in waits:
                h.observe(w)
        stats["conveyor_depth"] = qs["depth"]
        # data-movement byte counters (always-on, obs.timeline): bytes
        # read from blobs, decoded, staged to device and served resident
        # — the /counters movement surface
        from ydb_tpu_torch.obs import timeline as _tl

        mv = _tl.movement_snapshot()
        if mv:
            g = self.counters.group(component="movement")
            for k, v in mv.items():
                g.counter(k).set(v)
        # chaos telemetry (only when a scenario is armed or counted):
        # per-site hit/fired counts, fallbacks taken and retry totals,
        # under component="chaos"
        cs = chaos.counters_snapshot()
        if cs:
            for site, st in cs.get("sites", {}).items():
                g = self.counters.group(component="chaos", site=site)
                g.counter("hits").set(st["hits"])
                g.counter("fired").set(st["fired"])
            for site, n in cs.get("fallbacks", {}).items():
                self.counters.group(
                    component="chaos",
                    site=site).counter("fallbacks").set(n)
            for site, n in cs.get("retries", {}).items():
                self.counters.group(
                    component="chaos",
                    site=site).counter("retries").set(n)
        # batching dispatcher telemetry (serving tier)
        bt = self.batcher
        if bt.armed() or bt.batches or bt.solo:
            g = self.counters.group(component="batching")
            for k, v in bt.snapshot().items():
                g.counter(k).set(v)
            stats["batches"] = bt.batches
        # front-door tenancy telemetry: per-pool inflight/queued gauges
        if self.front_door is not None:
            for tname, row in self.front_door.snapshot().items():
                g = self.counters.group(component="serving",
                                        tenant=tname)
                for k in ("inflight", "queued"):
                    g.counter(k).set(row[k])
        # device-memory ledger (only when the footprint sanitizer is
        # armed): per-component live/peak bytes plus the process-wide
        # peak gauge under component="devmem"
        if _memsan.armed():
            for comp, t in _memsan.component_totals().items():
                g = self.counters.group(component="devmem", pool=comp)
                g.counter("live_bytes").set(t["live"])
                g.counter("peak_bytes").set(t["peak"])
                g.counter("charges").set(t["charges"])
                g.counter("releases").set(t["releases"])
                g.counter("evictions").set(t["evictions"])
            self.counters.group(component="devmem").counter(
                "global_peak_bytes").set(_memsan.global_peak())
            stats["devmem_peak_bytes"] = _memsan.global_peak()
        stats["slow_queries"] = self.check_slow_queries()
        return stats

    # ---- live query introspection ----

    def _register_active(self, sql: str, t0: float,
                         tenant: str = "") -> int:
        """Enter a statement into the in-flight registry (before
        admission, so queued statements are visible). Returns the token
        the caller must hand to _unregister_active in a finally."""
        with self._active_lock:
            self._active_seq += 1
            tok = self._active_seq
            pos = sum(1 for e in self.active_queries.values()
                      if e["stage"] == "queued")
            self.active_queries[tok] = {
                "sql": sql, "start": t0, "stage": "queued",
                "queue_position": pos, "trace_id": 0, "kind": "",
                "rows": 0, "slow_fired": False,
                "batch_id": 0, "batch_size": 0, "shared_scan": 0,
                "tenant": tenant,
            }
            lk = _leaksan.track("session.active", sql[:60], owner=tok)
            if lk is not None:
                self._active_leaks[tok] = lk
        return tok

    def _update_active(self, tok: int, **fields) -> None:
        with self._active_lock:
            e = self.active_queries.get(tok)
            if e is not None:
                e.update(fields)

    def _unregister_active(self, tok: int) -> None:
        with self._active_lock:
            self.active_queries.pop(tok, None)
            if self._active_leaks:
                _leaksan.close(self._active_leaks.pop(tok, None))

    def active_query_snapshot(self) -> list[dict]:
        """Point-in-time view of in-flight statements, longest-running
        first."""
        now = _time.monotonic()
        with self._active_lock:
            entries = [dict(e) for e in self.active_queries.values()]
        for e in entries:
            e["elapsed_seconds"] = now - e.pop("start")
            e.pop("slow_fired", None)
        entries.sort(key=lambda e: -e["elapsed_seconds"])
        return entries

    def check_slow_queries(self) -> int:
        """Fire the query.slow probe for any in-flight statement past
        the YDB_TPU_TORCH_SLOW_QUERY_SECONDS threshold (once per
        statement, also counted into ``slow_queries``). Rides the
        run_background cadence; callable directly too."""
        try:
            threshold = float(os.environ.get(
                "YDB_TPU_TORCH_SLOW_QUERY_SECONDS", "") or 1.0)
        except ValueError:
            threshold = 1.0
        now = _time.monotonic()
        fired = 0
        with self._active_lock:
            for e in self.active_queries.values():
                if e["slow_fired"] or now - e["start"] < threshold:
                    continue
                e["slow_fired"] = True
                _P_SLOW.fire(
                    elapsed=round(now - e["start"], 3),
                    stage=e["stage"], sql=e["sql"][:120])
                fired += 1
            self.slow_queries += fired
        return fired

    def _auto_reshard(self, stats: dict) -> None:
        """Load-driven splits/merges from table statistics: rows/shard
        above the split threshold doubles shards; below threshold/8
        (hysteresis) halves them."""
        split_at = self.icb.get("split_rows_per_shard")
        if not split_at:
            return
        for name, st in table_stats(self).items():
            t = self.tables.get(name)
            rows = st.get("rows")
            if t is None or rows is None:
                continue
            if getattr(t, "upsert", False):
                # portion-metadata counts include superseded versions on
                # upsert tables: acting on them would split on churn
                continue
            if rows == 0:
                # empty = likely pre-split ahead of a bulk load
                continue
            n = len(t.shards)
            per_shard = rows / n
            floor = max(self.config.min_auto_shards, 1)
            if per_shard > split_at and n < self.config.max_auto_shards:
                self.reshard_table(name, min(n * 2,
                                             self.config.max_auto_shards))
                stats["splits"] += 1
            elif n > floor and per_shard < split_at / 8:
                self.reshard_table(name, max(n // 2, floor))
                stats["merges"] += 1

    def health(self) -> dict:
        return health_check(self)

    # ---- row-store DML (UPDATE / DELETE) ----

    def _row_table(self, name: str):
        from ydb_tpu_torch.datashard.table import RowTable

        t = self.tables.get(name)
        if t is None:
            raise PlanError(f"unknown table {name}")
        if not isinstance(t, RowTable):
            raise PlanError(
                f"{name} is a column-store table; UPDATE/DELETE need a "
                f"row table (CREATE TABLE ... WITH (store = row))")
        return t

    @_host_ok("row DML readback: plans an uncached derived SELECT and"
              " fetches matching rows to host — the row store operates"
              " on host rows by design")
    def _select_rows(self, table, extra_items, where, snap):
        """Run SELECT pk..., extra... FROM table WHERE ... through the
        normal plan/execute path at the given snapshot."""
        items = [ast.SelectItem(ast.Name((c,)), f"__pk_{i}")
                 for i, c in enumerate(table.pk_columns)]
        items += extra_items
        sel = ast.Select(
            items=tuple(items),
            from_=ast.TableRef(table.name, None),
            where=where, group_by=(), having=None, order_by=(),
            limit=None,
        )
        p = plan_select(sel, self.catalog())
        db = self.snapshot_db(snap)
        keys = _pinned_keys(table, where)
        if keys is not None:
            # the WHERE pins the key: only those rows can match, so the
            # statement reads them by point reads instead of a walk of
            # every row of the table (same rows, same order)
            db.sources[table.name] = table.source_of_keys(keys, snap)
        out = to_host(execute_plan(p, db))
        n = out.num_rows
        keys = [
            tuple(int(out.column(f"__pk_{i}")[r])
                  for i in range(len(table.pk_columns)))
            for r in range(n)
        ]
        return out, keys

    def update(self, stmt: ast.Update) -> TxResult:
        t = self._row_table(stmt.table)
        for name, _ in stmt.sets:
            if name not in t.schema:
                raise PlanError(f"no column {name}")
            if name in t.pk_columns:
                raise PlanError(f"cannot UPDATE key column {name}")
        # optimistic read-modify-write: lock, read at snapshot, write
        # under the lock; a conflicting commit in between breaks the
        # lock, prepare aborts the 2PC, and the whole RMW retries
        for _attempt in range(self.icb.get("rmw_retries")):
            locks = t.lock_all_shards()
            try:
                res = self._update_once(t, stmt, locks)
            finally:
                t.release_locks(locks)
            if res.committed or not (res.error or "").startswith(
                    "prepare"):
                return res
        raise PlanError(
            f"UPDATE {stmt.table} kept aborting on concurrent writes")

    def _update_once(self, t, stmt: ast.Update,
                     locks: dict[int, int]) -> TxResult:
        snap = self.coordinator.read_snapshot()
        ops = self.update_ops(t, stmt, snap)
        if not ops:
            return TxResult(0, snap, True)
        return t._commit_ops(ops, lock_ids=locks)

    @_host_ok("row DML read-modify-write: per-row SET application and"
              " dictionary re-encoding are host row work by design")
    def _update_rows(self, t, stmt: ast.Update, snap: int):
        """Rows with the SET effects applied, read at ``snap``."""
        # constant SET values evaluate directly (string literals cannot
        # ride the device plan — they'd be bare dict ids); computed
        # expressions run through the normal SELECT path
        const_sets: dict[str, tuple] = {}
        copy_sets: list[tuple[str, str]] = []  # target <- source column
        computed: list[tuple[str, ast.Expr]] = []
        for name, e in stmt.sets:
            lit = e
            f = t.schema.field(name)
            if isinstance(lit, (ast.Literal,)) or (
                    isinstance(lit, ast.UnOp) and lit.op == "neg" and
                    isinstance(lit.operand, ast.Literal)):
                v, ok = _literal_value(lit, f.type)
                if ok and f.type.is_string:
                    v = int(self.dicts.for_column(name).add(v))
                const_sets[name] = (v, ok)
            elif f.type.is_string:
                # dict ids are per-column: a cross-column copy must
                # decode in the source dictionary and re-encode in the
                # target's — raw id passthrough would alias wrong values
                if isinstance(e, ast.Name) and e.column in t.schema and \
                        t.schema.field(e.column).type.is_string:
                    copy_sets.append((name, e.column))
                else:
                    raise PlanError(
                        f"UPDATE SET {name} = <expr>: string columns "
                        f"support literals or another string column")
            else:
                computed.append((name, e))
        extra = [ast.SelectItem(e, f"__set_{i}")
                 for i, (_n, e) in enumerate(computed)]
        out, keys = self._select_rows(t, extra, stmt.where, snap)
        current = t.read_rows(keys, snap)  # one batched read per shard
        rows = []
        for r, key in enumerate(keys):
            row = current.get(key)
            if row is None:
                continue
            row = dict(row)
            for name, (v, ok) in const_sets.items():
                row[name] = v if ok else None
            for name, src in copy_sets:
                sid = row.get(src)
                if sid is None:
                    row[name] = None
                else:
                    value = self.dicts[src].decode(
                        np.asarray([sid], dtype=np.int32))[0]
                    row[name] = int(self.dicts.for_column(name).add(value))
            for i, (name, _e) in enumerate(computed):
                col = out.column(f"__set_{i}")
                ok = bool(out.validity(f"__set_{i}")[r])
                if not ok:
                    row[name] = None
                else:
                    row[name] = _coerce(
                        col[r], out.schema.field(f"__set_{i}").type,
                        t.schema.field(name).type)
            rows.append(row)
        return rows

    def update_ops(self, t, stmt: ast.Update, snap: int):
        """The UPDATE's row effects as RowOps, uncommitted (the
        interactive-transaction buffering seam)."""
        from ydb_tpu_torch.datashard.shard import RowOp

        rows = self._update_rows(t, stmt, snap)
        return [RowOp(t._key_of(r), r) for r in rows]

    def delete_ops(self, t, stmt: ast.Delete, snap: int):
        from ydb_tpu_torch.datashard.shard import RowOp

        _out, keys = self._select_rows(t, [], stmt.where, snap)
        return [RowOp(tuple(k), None) for k in keys]

    def delete(self, stmt: ast.Delete) -> TxResult:
        t = self._row_table(stmt.table)
        for _attempt in range(self.icb.get("rmw_retries")):
            locks = t.lock_all_shards()
            try:
                res = self._delete_once(t, stmt, locks)
            finally:
                t.release_locks(locks)
            if res.committed or not (res.error or "").startswith(
                    "prepare"):
                return res
        raise PlanError(
            f"DELETE {stmt.table} kept aborting on concurrent writes")

    def _delete_once(self, t, stmt: ast.Delete,
                     locks: dict[int, int]) -> TxResult:
        snap = self.coordinator.read_snapshot()
        ops = self.delete_ops(t, stmt, snap)
        if not ops:
            return TxResult(0, snap, True)
        return t._commit_ops(ops, lock_ids=locks)

    @property
    def sequences(self):
        if self._sequences is None:
            from ydb_tpu_torch.tablet.kesus import SequenceShard

            with self._qid_lock:  # double-boot would fork the journal
                if self._sequences is None:
                    self._sequences = SequenceShard("cluster",
                                                    self.store)
        return self._sequences

    def insert(self, stmt: ast.Insert) -> TxResult:
        t, arrays, val = self._insert_arrays(stmt)
        res = t.insert(arrays, val)  # journals dict growth via pre_commit
        # new dictionary entries may invalidate cached plan aux tables
        self._invalidate_plans()
        return res

    def insert_ops(self, stmt: ast.Insert):
        """The INSERT's effects as (table, RowOps), uncommitted (the
        interactive-transaction buffering seam; row tables only)."""
        t, arrays, val = self._insert_arrays(stmt)
        if not hasattr(t, "insert_ops"):
            raise PlanError(
                f"interactive transactions support row tables; "
                f"{stmt.table} is a column table")
        self._invalidate_plans()
        return t, t.insert_ops(arrays, val)

    def _insert_arrays(self, stmt: ast.Insert):
        t = self.tables.get(stmt.table)
        if t is None:
            raise PlanError(f"unknown table {stmt.table}")
        names = stmt.columns or t.schema.names
        cols: dict[str, list] = {n: [] for n in names}
        validity: dict[str, list] = {n: [] for n in names}
        for row in stmt.rows:
            if len(row) != len(names):
                raise PlanError("row arity mismatch")
            for n, e in zip(names, row):
                if isinstance(e, ast.FuncCall) and e.name == "nextval":
                    # volatile per-row default from the durable
                    # sequence allocator (kqp sequencer analog)
                    if len(e.args) != 1 or not (
                            isinstance(e.args[0], ast.Literal)
                            and e.args[0].kind == "string"):
                        raise PlanError(
                            "nextval needs a sequence name literal")
                    arg = e.args[0]
                    cols[n].append(self.sequences.next_val(arg.value))
                    validity[n].append(True)
                    continue
                v, ok = _literal_value(e, t.schema.field(n).type)
                cols[n].append(v)
                validity[n].append(ok)
        missing = [n for n in t.schema.names if n not in cols]
        if missing:
            raise PlanError(f"INSERT must set all columns; missing {missing}")
        arrays = {}
        for n in names:
            f = t.schema.field(n)
            if f.type.is_string:
                arrays[n] = cols[n]
            else:
                arrays[n] = np.asarray(cols[n], dtype=f.type.physical)
        val = {n: np.asarray(v, dtype=bool) for n, v in validity.items()}
        return t, arrays, val

    def reshard_table(self, name: str, n_shards: int) -> int:
        """Split/merge a table (column OR row store) to ``n_shards``
        shards: stream-copy into a new shard generation, journal the
        cutover in the scheme (the durable commit point), then GC the
        old generation. Returns the new generation."""
        t = self.tables.get(name)
        if t is None:
            raise PlanError(f"unknown table {name}")
        if n_shards < 1:
            # validate BEFORE the destructive copy/swap, not after
            raise PlanError("n_shards must be >= 1")
        old_n = len(t.shards)
        old_gen = t.gen
        old_ids = [sh.shard_id for sh in t.shards]
        new_gen = t.reshard(n_shards)
        # durable cutover: after this journal entry a reboot sees the
        # new generation; before it, the new blobs are swept as orphans
        self.scheme.reshard_table("/" + name, n_shards, new_gen)
        t.drop_generation_storage(old_gen, old_n)
        # the old generation's per-portion sketches can never be read
        # again (generation-scoped shard ids)
        self.stats.forget(name, old_ids)
        self._invalidate_plans()
        return new_gen

    # ---- query path ----

    def catalog(self) -> Catalog:
        schemas = {n: t.schema for n, t in self.tables.items()}
        # the FULL primary key: the planner takes a lookup join when a
        # build side's key covers it, so a composite key reported as its
        # first column alone (the reference's ``(t.pk_column,)``) turns a
        # many-rows-per-key join into a lookup and drops rows
        pks = dict(self.primary_keys)
        if self.flags.enable_sys_views:
            for name, schema in SYS_SCHEMAS.items():
                schemas.setdefault(name, schema)
                pks.setdefault(name, (schema.names[0],))
        # statistics feed for CBO-lite join ordering (cheap: portion
        # metadata only, no scans)
        counts = {n: st["rows"] for n, st in table_stats(self).items()
                  if st["rows"] is not None}
        return Catalog(schemas=schemas, primary_keys=pks,
                       dicts=self.dicts, row_counts=counts,
                       table_stats=self.stats.all_stats(),
                       udfs=dict(self.udfs))

    def _stmt_scalar_exec(self, stmt_db: list, snap: int | None = None,
                          access_check=None):
        """Scalar-subquery executor bound to ONE statement snapshot
        (lazily created into ``stmt_db[0]``): the KQP precompute-phase
        analog, shared by SELECT planning and EXPLAIN."""
        def scalar_exec(plan_node, t):
            if access_check is not None:
                access_check(plan_node)
            if stmt_db[0] is None:
                stmt_db[0] = self.snapshot_db(
                    snap, include_sys=self.flags.enable_sys_views)
            out = to_host(execute_plan(plan_node, stmt_db[0]))
            col = out.schema.names[0]
            v, ok = out.cols[col]
            if len(v) != 1:
                raise PlanError(
                    f"scalar subquery returned {len(v)} rows")
            return v[0].item(), bool(ok[0])

        return scalar_exec

    def register_udf(self, name: str, fn, out_type) -> None:
        """Register a scalar UDF: ``fn`` takes numpy arrays (one per SQL
        argument) and returns an array; usable in any expression."""
        self.udfs[name.lower()] = (fn, out_type)
        self._invalidate_plans()

    def snapshot_db(self, snap: int | None = None,
                    include_sys: bool = False) -> Database:
        """The Database a statement reads: every column table's shard
        streams at one snapshot, on the cluster's device, and every row
        table's ``source_at`` at the same snapshot, built when the
        statement first reads it (``_RowSources``); with
        ``include_sys``, each sys view likewise."""
        from ydb_tpu_torch.datashard.table import RowTable

        snap = self.coordinator.read_snapshot() if snap is None else snap
        self._prune_scan_cache()
        sources = _RowSources(snap, self if include_sys else None)
        for name, t in self.tables.items():
            if isinstance(t, RowTable):
                sources.row_tables[name] = t
            else:
                sources[name] = _merge_shard_sources(t, snap)
        db = Database(sources=sources, dicts=self.dicts,
                      device=self.device)
        db.block_cache = self.scan_block_cache
        # compiled programs persist across statements (the node-scoped
        # pattern cache): the second run of a SELECT is a compile-cache
        # hit — warm execute only
        db._compile_cache = self._compile_cache
        return db

    def _prune_scan_cache(self) -> None:
        """Free cluster-cache entries pinned by GC'd portions (every
        statement snapshots through here; an entry naming a portion
        absent from the live portion maps can never be keyed again)."""
        if not len(self.scan_block_cache):
            return
        if self.scan_block_cache.budget() <= 0:
            # the budget closed mid-process: entries cached under the
            # earlier budget can never be served again
            self.scan_block_cache.clear()
            return
        # portions only vanish on GC (meta_gen bumps) or reshard (the
        # shard set changes): while the stamp is stable there is nothing
        # to prune
        stamp = tuple(
            (s.shard_id, getattr(s, "meta_gen", 0))
            for t in self.tables.values()
            for s in t.shards)
        if stamp == self._prune_stamp:
            return
        live: dict[str, set] = {}
        for t in self.tables.values():
            for s in t.shards:
                if not hasattr(s, "portions"):
                    continue  # row shards cache nothing here
                with s._meta_lock:
                    pids = set(s.portions)
                live.setdefault(s.shard_id, set()).update(pids)

        def alive(key) -> bool:
            try:
                return all(
                    sid in live and live[sid].issuperset(pids)
                    for sid, pids in key[0])
            except (TypeError, ValueError, IndexError):
                return True  # unknown key shape: never drop blindly
        self.scan_block_cache.prune(alive)
        self._prune_stamp = stamp

    def plan(self, sql: str, snap: int | None = None,
             access_check=None):
        """``snap`` pins the statement snapshot (a transaction's BEGIN
        snapshot): scalar subqueries precompute against it, and such
        plans never enter the cache. ``access_check(plan_node)`` gates
        plan-time subquery execution (ACL enforcement happens BEFORE any
        table is read)."""
        from ydb_tpu_torch.obs import tracing

        if snap is None and access_check is None:
            hit = self._plan_cache.get(sql)
            if hit is not None:
                if _P_PLAN_CACHE:
                    _P_PLAN_CACHE.fire(hit=True)
                tracing.annotate(plan_cache="hit")
                self._plan_cache.move_to_end(sql)
                return hit
            if _P_PLAN_CACHE:
                _P_PLAN_CACHE.fire(hit=False)
            tracing.annotate(plan_cache="miss")
        with tracing.span("parse"):
            stmt = parse(sql)
        if isinstance(stmt, ast.Explain):
            # EXPLAIN precomputes scalar subqueries exactly like
            # execution would, so the rendered plan is the plan the
            # engine would run
            stmt_db: list = [None]
            pq = plan_select_full(
                stmt.select, self.catalog(),
                self._stmt_scalar_exec(stmt_db, snap, access_check))
            return ("explain", pq.plan, dict(pq.dict_aliases),
                    stmt_db[0], stmt.analyze)
        if not isinstance(stmt, (ast.Select, ast.UnionAll)):
            return stmt

        # one snapshot Database for the whole statement: scalar-subquery
        # precompute and (if any ran) the outer execution read the same
        # state, preserving statement-level read consistency
        stmt_db: list = [None]
        pq = plan_select_full(
            stmt, self.catalog(),
            self._stmt_scalar_exec(stmt_db, snap, access_check))
        entry = (pq.plan, dict(pq.dict_aliases), stmt_db[0])
        if not pq.used_scalar_exec and snap is None \
                and access_check is None:
            # plans with baked-in subquery results (or pinned to a tx
            # snapshot) are snapshot-bound: never serve from the cache
            self._plan_cache[sql] = entry
            while len(self._plan_cache) > self._plan_cache_size:
                self._plan_cache.popitem(last=False)
        return entry

    def result_dicts(self, out_schema, alias_map: dict) -> DictionarySet:
        """Per-result dictionary view: each output string column bound
        to its SOURCE column's dictionary (aliases included), so decode
        never guesses by output name."""
        view = DictionarySet()
        for f in out_schema.fields:
            if f.type.is_string:
                src = alias_map.get(f.name, f.name)
                if src in self.dicts:
                    view._dicts[f.name] = self.dicts[src]
        return view

    def session(self) -> "Session":
        return Session(self)


class _RowSources(dict):
    """A statement's sources: column tables' streams set eagerly, a row
    table's ``source_at(snap)`` built on its first lookup and kept for
    the rest of the statement, so a statement that reads no row table
    walks none (the reference's mesh path, ``_Lazy`` in
    ``ydb_tpu/kqp/session.py``). With a ``sys_cluster``, each sys view
    (``obs/sysview.py``) builds on its first lookup too, so a statement
    that reads no sys view builds none (the reference's
    ``_SysLazySources``). ``get`` and ``in`` build too: fusion and
    batching probe with ``sources.get``, which a plain dict answers
    without ``__missing__``. The lock keeps two workers of one statement
    from building the same table twice."""

    def __init__(self, snap: int, sys_cluster=None):
        super().__init__()
        self.snap = snap
        self.row_tables: dict = {}
        self._sys_cluster = sys_cluster
        self._build_lock = threading.Lock()

    def __missing__(self, key):
        t = self.row_tables.get(key)
        if t is None and not self._is_sys(key):
            raise KeyError(key)
        with self._build_lock:
            if dict.__contains__(self, key):
                return dict.__getitem__(self, key)
            if t is not None:
                src = t.source_at(self.snap)
            else:
                from ydb_tpu_torch.obs.sysview import sys_source

                src = sys_source(self._sys_cluster, key)
            self[key] = src
            return src

    def _is_sys(self, key) -> bool:
        return self._sys_cluster is not None and key in SYS_SCHEMAS

    def get(self, key, default=None):
        try:
            return self[key]
        except KeyError:
            return default

    def __contains__(self, key):
        if dict.__contains__(self, key) or key in self.row_tables:
            return True
        if self._is_sys(key):
            self[key]  # builds the view, as a lookup would
            return True
        return False


def _merge_shard_sources(t: ShardedTable, snap: int):
    """Streaming scan source over all shards at a snapshot: SELECTs read
    through the portion/blob/merge path (engine.reader), never a
    materialized table — dedup under upsert included."""
    from ydb_tpu_torch.engine.reader import MultiShardStreamSource

    return MultiShardStreamSource(t.shards, t.schema, t.dicts, snap,
                                  device=t.device)


_INT_KINDS = frozenset(("int8", "int16", "int32", "int64", "uint8",
                        "uint16", "uint32", "uint64"))


def _pinned_keys(table, where) -> list | None:
    """The primary keys a row-DML WHERE pins, or None: a top-level
    conjunct ``pk = <int>`` or ``pk IN (<int>, ...)`` on a table whose
    key is one integer column. Rows with other keys cannot match, so
    reading just these rows answers the derived SELECT exactly."""
    if where is None or len(table.pk_columns) != 1:
        return None
    pk = table.pk_columns[0]
    if table.schema.field(pk).type.kind.value not in _INT_KINDS:
        return None

    def is_pk(e) -> bool:
        return isinstance(e, ast.Name) and e.column == pk and (
            len(e.parts) == 1 or e.parts[-2] == table.name)

    def as_int(e):
        if isinstance(e, ast.Literal) and e.kind == "int" \
                and -(1 << 63) <= int(e.value) < (1 << 63):
            return int(e.value)
        if isinstance(e, ast.UnOp) and e.op == "neg":
            v = as_int(e.operand)
            return None if v is None else -v
        return None

    stack, pinned = [where], None
    while stack:
        e = stack.pop()
        keys = None
        if isinstance(e, ast.BinOp) and e.op == "and":
            stack += [e.left, e.right]
        elif isinstance(e, ast.BinOp) and e.op == "eq":
            for a, b in ((e.left, e.right), (e.right, e.left)):
                if is_pk(a) and as_int(b) is not None:
                    keys = {as_int(b)}
        elif isinstance(e, ast.InList) and not e.negated and \
                is_pk(e.expr):
            vals = [as_int(i) for i in e.items]
            if all(v is not None for v in vals):
                keys = set(vals)
        if keys is not None:
            pinned = keys if pinned is None else pinned & keys
    return None if pinned is None else [(k,) for k in sorted(pinned)]


def _coerce(value, from_t: dtypes.LogicalType, to_t: dtypes.LogicalType):
    """Physical value conversion for UPDATE SET results."""
    v = value
    if to_t.is_decimal:
        if from_t.is_decimal:
            return int(v) * 10 ** (to_t.scale - from_t.scale) \
                if to_t.scale >= from_t.scale else \
                int(int(v) // 10 ** (from_t.scale - to_t.scale))
        if from_t.is_floating:
            return int(round(float(v) * 10 ** to_t.scale))
        return int(v) * 10 ** to_t.scale
    if to_t.is_floating:
        if from_t.is_decimal:
            return float(v) / 10 ** from_t.scale
        return float(v)
    if to_t.is_string:
        return int(v)  # dict id flows through unchanged
    return int(v)


def _literal_value(e: ast.Expr, t: dtypes.LogicalType):
    """Evaluate an INSERT literal to (physical value, validity)."""
    if isinstance(e, ast.Literal):
        if e.kind == "null":
            return (b"" if t.is_string else 0), False
        if e.kind == "string":
            if t.is_string:
                return e.value.encode(), True
            raise PlanError(f"string literal for {t}")
        if e.kind == "decimal":
            if t.is_floating:
                # fractional literal into a float/double column: the
                # decimal-scaling path would round 0.5 to integral 0
                return float(e.value), True
            import decimal as pydec

            return int(
                pydec.Decimal(e.value).scaleb(t.scale).to_integral_value()
            ), True
        if e.kind in ("int", "bool"):
            if t.is_decimal:
                return int(e.value) * 10 ** t.scale, True
            return e.value, True
    if isinstance(e, ast.UnOp) and e.op == "neg":
        v, ok = _literal_value(e.operand, t)
        return -v, ok
    if isinstance(e, ast.FuncCall) and e.name == "date":
        return int(np.datetime64(e.args[0].value, "D").astype(np.int32)), True
    raise PlanError(f"unsupported INSERT value {e}")


@dataclasses.dataclass
class Session:
    """One client session (kqp_session_actor analog).

    BEGIN / COMMIT / ROLLBACK: statements inside the transaction read
    the BEGIN snapshot (repeatable read), scalar subqueries included.
    INSERT, UPDATE and DELETE of row tables buffer their effects under
    full-range optimistic locks on the tables they touch; COMMIT
    proposes every table's effects and commits them as ONE volatile
    distributed transaction, which a conflicting commit aborts. A
    column table inside a transaction raises ``PlanError``, as in the
    reference."""

    cluster: Cluster
    _tx: dict | None = None
    # authenticated principal (the auth token); None = internal
    # session, exempt from ACL checks
    principal: str | None = None
    # workload pool this session's statements admit under (serving/
    # tenants.py); None = resolve through the front door registry
    tenant: str | None = None
    # QueryProfile of the most recent statement (None with profiling
    # disabled — YDB_TPU_TORCH_PROFILE=0)
    last_profile: object = None

    def execute(self, sql: str, trace_id: int | None = None,
                timeout: float | None = None):
        """Returns OracleTable for SELECT, TxResult for INSERT, None DDL.

        ``timeout`` is the statement deadline in seconds: it bounds the
        admission wait AND rides the dispatching thread as a
        :class:`~ydb_tpu_torch.chaos.deadline.Deadline`, so scans, fused
        dispatches and DQ pumps cancel cooperatively at their block
        boundaries (``StatementCancelled``)."""
        from ydb_tpu_torch.chaos import deadline as _dl
        from ydb_tpu_torch.kqp.rm import OverloadedError

        c = self.cluster
        if c.quoter is not None and not c.quoter.try_acquire(
                "kqp/requests"):
            from ydb_tpu_torch.runtime.quoter import ThrottledError

            c.counters.group(kind="throttled").counter("queries").inc()
            raise ThrottledError("request rate limit exceeded")
        t0 = _time.monotonic()  # BEFORE admission: queue wait is part
        # of the latency operators observe
        # load shedding BEFORE the statement enters the registry: past
        # the configured in-flight limit the cluster fails fast with a
        # typed error instead of queueing unboundedly. The chaos
        # "session.admit" site injects the same overload. With a front
        # door installed the per-tenant caps are the shedding boundary
        # and this global valve is only a backstop.
        limit = c.max_inflight_statements
        shed = limit > 0 and len(c.active_queries) >= limit
        fault = None if shed else chaos.hit("session.admit")
        if fault is not None:
            fault.sleep()
            shed = shed or fault.kind == "overload"
        if shed:
            c.counters.group(kind="overloaded").counter("queries").inc()
            self._record_rejected(sql, t0, "overloaded")
            raise OverloadedError(
                f"statement shed at admission "
                f"({len(c.active_queries)} in flight, limit {limit})"
                if limit else "statement shed at admission (injected)")
        statement_dl = _dl.Deadline(timeout) if timeout is not None \
            else None
        fd = c.front_door
        tenant = fd.registry.resolve(tenant=self.tenant,
                                     principal=self.principal) \
            if fd is not None else (self.tenant or "")
        # the statement enters the live registry BEFORE admission so
        # queued statements are visible too; the finally guarantees it
        # clears even when execution raises
        tok = c._register_active(sql, t0, tenant=tenant)
        seat = None
        qid = None
        try:
            if c.workload is not None or c.rm is not None:
                with c._qid_lock:
                    c._query_seq += 1
                    qid = f"q{c._query_seq}"
            deadline = t0 + 30.0
            if statement_dl is not None:
                # the statement deadline caps the admission wait too
                deadline = min(deadline, statement_dl.at)
            if fd is not None:
                # per-tenant seat: the front door queues (deadline-
                # ordered) against THIS tenant's cap and sheds with the
                # pool named
                try:
                    seat = fd.admit(
                        tenant,
                        deadline_at=(statement_dl.at
                                     if statement_dl is not None
                                     else None),
                        timeout=max(0.0, deadline - _time.monotonic()),
                        owner=tok)
                except OverloadedError:
                    c.counters.group(
                        kind="overloaded").counter("queries").inc()
                    self._record_rejected(sql, t0, "overloaded")
                    raise
            pool = tenant if fd is not None else "default"
            if c.workload is not None:
                # pool admission: run now or condition-wait our turn
                if not c.workload.admit(qid, pool=pool) and not \
                        c.workload.wait_admitted(
                            qid, pool=pool,
                            timeout=deadline - _time.monotonic()):
                    c.workload.finish(qid, pool=pool)
                    from ydb_tpu_torch.kqp.rm import PoolOverloaded

                    self._record_rejected(sql, t0, "overloaded")
                    raise PoolOverloaded("admission wait timed out")
            # from here the pool admission is HELD: one try/finally owns
            # BOTH planes, so any exception between admission and the
            # compute-slot grant releases the pool entry
            granted = False
            try:
                if c.rm is not None:
                    # a pool-admitted query still waits (not fails) for
                    # a compute slot
                    from ydb_tpu_torch.kqp.rm import ResourceExhausted

                    while True:
                        try:
                            c.rm.acquire(qid, slots=1)
                            granted = True
                            break
                        except ResourceExhausted:
                            if _time.monotonic() > deadline:
                                self._record_rejected(sql, t0,
                                                      "overloaded")
                                raise
                            _time.sleep(0.002)
                with _dl.activate(statement_dl):
                    return self._execute_admitted(sql, trace_id, t0,
                                                  active_tok=tok)
            finally:
                if granted:
                    c.rm.release(qid)
                if c.workload is not None:
                    c.workload.finish(qid, pool=pool)
        finally:
            if seat is not None:
                seat.release()
            c._unregister_active(tok)
            # statement-completion drain check: under the leak sanitizer
            # every handle owned by this statement (its registry row,
            # its compute-slot grant) must be closed by now — one bool
            # test per hook when the sanitizer is off
            _leaksan.assert_drained(owner=tok,
                                    where="statement completion")
            if qid is not None:
                _leaksan.assert_drained(owner=qid,
                                        where="statement completion")

    def _record_rejected(self, sql: str, t0: float, reason: str) -> None:
        """Statements rejected BEFORE execution (shed/admission
        timeout) still land in the profile ring as typed errors."""
        from ydb_tpu_torch.obs import tracing

        if not tracing.profiling_enabled():
            return
        from ydb_tpu_torch.obs.profile import QueryProfile

        p = QueryProfile(sql=sql, kind="error", query_class="error",
                         seconds=_time.monotonic() - t0, error=1,
                         error_reason=reason)
        self.last_profile = p
        self.cluster.profiles.add(p)

    def _execute_admitted(self, sql: str, trace_id: int | None = None,
                          t0: float | None = None,
                          active_tok: int | None = None):
        import contextlib

        from ydb_tpu_torch.obs import tracing

        c = self.cluster
        if t0 is None:
            t0 = _time.monotonic()
        # profiling on (default): the root span is ACTIVATED so every
        # layer below threads children under this trace id.
        # YDB_TPU_TORCH_PROFILE=0 keeps the root/plan/execute spans but
        # skips activation: no child spans, no profile assembly.
        prof = tracing.profiling_enabled()

        def act(sp):
            return tracing.activate(sp) if prof \
                else contextlib.nullcontext()

        planned = None
        kind = "error"
        span = None
        _ss = None
        _ms = None
        # the batching dispatcher stamps batch_id/batch_size onto this
        # statement's registry row; sessions run one statement at a time
        self._active_tok = active_tok
        try:
            with c.tracer.trace("query", trace_id) as span:
                # syncsan window covers plan+execute+fetch: copies,
                # syncs, captures, builds and compiles attribute to THIS
                # statement (conveyor workers resolve via the trace id)
                _ss = _syncsan.begin_statement(
                    sql, trace_id=span.trace_id, span=span)
                # memsan window rides the same bounds: device-byte
                # charges attribute to THIS statement, and its warm
                # budget enforces on close just like syncsan's
                _ms = _memsan.begin_statement(
                    sql, trace_id=span.trace_id, span=span)
                c._update_active(active_tok, stage="plan",
                                 trace_id=span.trace_id)
                with act(span):
                    with span.child("plan") as plan_span:
                        with act(plan_span):
                            planned = c.plan(
                                sql,
                                snap=(self._tx["snap"]
                                      if self._tx else None),
                                access_check=(
                                    self._plan_access_check
                                    if self.principal is not None
                                    else None))
                        if not isinstance(planned, tuple):
                            kind = type(planned).__name__.lower()
                        elif planned[0] == "explain":
                            kind = "explain"
                        else:
                            kind = "select"
                        plan_span.set(kind=kind)
                    span.set(kind=kind)
                    c._update_active(active_tok, stage="execute",
                                     kind=kind)
                    with span.child("execute") as exec_span:
                        with act(exec_span):
                            out = self._dispatch(planned)
                # totals attach BEFORE the root span finishes
                seconds = _time.monotonic() - t0
                rows = out.num_rows if isinstance(out, OracleTable) \
                    else 0
                span.set(seconds=round(seconds, 6), rows=rows)
                # close BEFORE the root span finishes so the syncsan_*
                # attrs land on a live span; a budget breach raises here
                # and surfaces as a statement error
                _syncsan.end_statement(_ss)
                _memsan.end_statement(_ms)
        except BaseException as e:
            _syncsan.discard(_ss)
            _memsan.discard(_ms)
            # statements that fail MID-EXECUTION still land in the
            # profile ring tagged error=1 plus a typed reason
            seconds = _time.monotonic() - t0
            c.counters.group(kind="error").counter("queries").inc()
            if prof and span is not None:
                reason = getattr(type(e), "reason", "") \
                    or type(e).__name__
                self._finish_profile(planned, sql, kind, span, seconds,
                                     0, error=1, reason=reason)
            raise
        c._update_active(active_tok, stage="done", rows=rows)
        c.query_log.append({"sql": sql, "kind": kind,
                            "seconds": seconds, "rows": rows})
        if kind != "select":
            # DDL/DML are audited; reads are not
            c.audit_log.append({
                "kind": kind, "sql": sql[:256], "status": "ok",
                "duration_us": int(seconds * 1e6),
            })
        g = c.counters.group(kind=kind)
        g.counter("queries").inc()
        g.histogram("latency_seconds").observe(seconds)
        if prof:
            self._finish_profile(planned, sql, kind, span, seconds,
                                 rows)
        if c.metering is not None:
            from ydb_tpu_torch.obs.metering import request_units

            c.metering.record(f"kqp.{kind}",
                              request_units(kind, rows))
        return out

    def _finish_profile(self, planned, sql: str, kind: str, span,
                        seconds: float, rows: int,
                        error: int = 0, reason: str = "") -> None:
        """Assemble the statement's QueryProfile from its finished span
        tree; feed last_profile, the profile ring and the per-query-
        class latency histogram with its p50/p99 gauges."""
        from ydb_tpu_torch.obs.profile import build_profile, \
            classify_plan, subtree

        c = self.cluster
        qc = kind
        if isinstance(planned, tuple):
            if planned[0] == "explain":
                qc = "explain"
            else:
                qc = classify_plan(planned[0])
        # scope to THIS statement's span subtree: a client-propagated
        # trace_id is shared across statements
        trace = c.tracer.spans_for(span.trace_id)
        scoped = [span] + subtree(trace, span.span_id)
        profile = build_profile(
            scoped, sql=sql, kind=kind,
            query_class=qc, seconds=seconds, rows=rows)
        fd = c.front_door
        tenant = fd.registry.resolve(tenant=self.tenant,
                                     principal=self.principal) \
            if fd is not None else (self.tenant or "")
        profile.tenant = tenant
        profile.error = error
        profile.error_reason = reason
        self.last_profile = profile
        c.profiles.add(profile)
        if error:
            # failed statements stay out of the per-class latency
            # surface — the ring entry is the record
            return
        if profile.compile_cache:
            c.counters.group(kind="compile_cache").counter(
                profile.compile_cache).inc()
        g = c.counters.group(query_class=qc)
        h = g.histogram("query_latency_seconds")
        h.observe(seconds)
        # percentile GAUGES beside the raw histogram
        g.counter("query_latency_p50").set(round(h.percentile(0.5), 9))
        g.counter("query_latency_p99").set(round(h.percentile(0.99), 9))
        if tenant:
            # the per-tenant SLO surface: same histogram + percentile
            # gauges, labeled by pool
            tg = c.counters.group(tenant=tenant, query_class=qc)
            th = tg.histogram("query_latency_seconds")
            th.observe(seconds)
            tg.counter("query_latency_p50").set(
                round(th.percentile(0.5), 9))
            tg.counter("query_latency_p99").set(
                round(th.percentile(0.99), 9))

    def _check_access(self, perm: str, *paths: str) -> None:
        """ACL gate (scheme ACEs with subtree inheritance): enforced
        for authenticated principals once any ACE exists; internal
        (principal-less) sessions and ACL-less clusters pass."""
        if self.principal is None:
            return
        scheme = self.cluster.scheme
        if not scheme.acl_enabled():
            return
        for path in paths:
            if perm == "read" and path.lstrip("/").startswith("sys_"):
                continue  # sys VIEWS are readable; only reads exempt
            if not scheme.check_access(self.principal, path, perm):
                raise PlanError(
                    f"access denied: {self.principal!r} lacks "
                    f"{perm!r} on {path}")

    def _plan_access_check(self, plan_node) -> None:
        self._check_access(
            "read", *("/" + t for t in self._plan_tables(plan_node)))

    @staticmethod
    def _plan_tables(node) -> set[str]:
        """Table names referenced by a plan (TableScan leaves)."""
        from ydb_tpu_torch.plan.nodes import TableScan

        out: set[str] = set()
        stack = [node]
        while stack:
            n = stack.pop()
            if isinstance(n, TableScan):
                out.add(n.table)
                continue
            for f in getattr(n, "__dataclass_fields__", {}):
                v = getattr(n, f)
                if hasattr(v, "__dataclass_fields__"):
                    stack.append(v)
        return out

    def _dispatch(self, planned):
        if isinstance(planned, ast.Begin):
            if self._tx is not None:
                raise PlanError("a transaction is already open")
            self._tx = {
                "snap": self.cluster.coordinator.read_snapshot(),
                "locks": {},   # table name -> {shard idx: lock id}
                "ops": {},     # table name -> (table, [RowOp]) ordered
            }
            return None
        if isinstance(planned, ast.Commit):
            return self._tx_commit()
        if isinstance(planned, ast.Rollback):
            self._tx_release()
            return None
        if isinstance(planned, ast.CreateSequence):
            self._no_tx("DDL")
            self._check_access("ddl", "/" + planned.name)
            self.cluster.sequences.create_sequence(
                planned.name, start=planned.start,
                increment=planned.increment, cache=planned.cache)
            return None
        if isinstance(planned, ast.DropSequence):
            self._no_tx("DDL")
            self._check_access("ddl", "/" + planned.name)
            self.cluster.sequences.drop_sequence(planned.name)
            return None
        if isinstance(planned, ast.CreateTable):
            self._no_tx("DDL")
            self._check_access("ddl", "/" + planned.table)
            self.cluster.create_table(planned)
            return None
        if isinstance(planned, ast.DropTable):
            self._no_tx("DDL")
            self._check_access("ddl", "/" + planned.table)
            self.cluster.drop_table(planned)
            return None
        if isinstance(planned, ast.AlterTable):
            self._no_tx("DDL")
            self._check_access("ddl", "/" + planned.table)
            self.cluster.alter_table(planned)
            return None
        if isinstance(planned, ast.Insert):
            self._check_access("write", "/" + planned.table)
            if self._tx is not None:
                t, ops = self.cluster.insert_ops(planned)
                self._tx_buffer(planned.table, t, ops)
                return None
            return self.cluster.insert(planned)
        if isinstance(planned, ast.Update):
            self._check_access("write", "/" + planned.table)
            if self._tx is not None:
                t = self.cluster._row_table(planned.table)
                self._tx_lock(planned.table, t)
                ops = self.cluster.update_ops(t, planned,
                                              self._tx["snap"])
                self._tx_buffer(planned.table, t, ops)
                return None
            return self.cluster.update(planned)
        if isinstance(planned, ast.Delete):
            self._check_access("write", "/" + planned.table)
            if self._tx is not None:
                t = self.cluster._row_table(planned.table)
                self._tx_lock(planned.table, t)
                ops = self.cluster.delete_ops(t, planned,
                                              self._tx["snap"])
                self._tx_buffer(planned.table, t, ops)
                return None
            return self.cluster.delete(planned)
        if planned[0] == "explain":
            from ydb_tpu_torch.plan.nodes import format_plan

            # EXPLAIN reveals schema/plan shape: same read gate as
            # executing the query would have
            self._plan_access_check(planned[1])
            if len(planned) > 4 and planned[4]:
                return self._explain_analyze(planned)
            return format_plan(planned[1])
        p, alias_map, plan_db = planned
        self._check_access(
            "read", *("/" + t for t in self._plan_tables(p)))
        db = self._statement_db(plan_db)
        from ydb_tpu_torch.obs import tracing

        blk = self._execute_select(p, db)
        with tracing.span("fetch"):
            # the device -> host result transfer is its own phase
            out = to_host(blk)
        out.dicts = self.cluster.result_dicts(out.schema, alias_map)
        return out

    def _execute_select(self, p, db):
        """Plan execution behind the batching dispatcher: when armed
        (YDB_TPU_TORCH_BATCH_WINDOW_MS > 0), compatible concurrent
        statements ride ONE shared fused device dispatch
        (kqp/batch.py); None from the batcher — disarmed, unbatchable
        plan, or a window that closed with a single member — falls
        through to the serial path (DQ -> fused -> walk)."""
        batcher = self.cluster.batcher
        if batcher.armed():
            blk = batcher.execute(
                p, db, cluster=self.cluster,
                active_tok=getattr(self, "_active_tok", None))
            if blk is not None:
                return blk
        return execute_plan(p, db)

    def _statement_db(self, plan_db) -> Database:
        """The Database a statement executes against — ONE set of
        snapshot rules shared by SELECT and EXPLAIN ANALYZE: reuse the
        plan-time snapshot when scalar subqueries precomputed against it
        (statement-level read consistency), else the BEGIN snapshot
        inside a transaction (repeatable read), else fresh."""
        if plan_db is not None:
            return plan_db
        if self._tx is not None:
            return self.cluster.snapshot_db(
                self._tx["snap"],
                include_sys=self.cluster.flags.enable_sys_views)
        return self.cluster.snapshot_db(
            include_sys=self.cluster.flags.enable_sys_views)

    def _explain_analyze(self, planned) -> str:
        """EXPLAIN ANALYZE: run the query for real (same snapshot rules
        as a SELECT), then render the plan annotated with the measured
        actuals — per-stage seconds, row counts and the
        compile-vs-execute split."""
        from ydb_tpu_torch.obs import tracing
        from ydb_tpu_torch.obs.profile import build_profile, \
            classify_plan, format_plan_analyzed, subtree

        _, p, _aliases, plan_db, _an = planned
        db = self._statement_db(plan_db)
        t0 = _time.monotonic()
        snap = None
        msnap = None
        _ss = None
        _ms = None
        try:
            with tracing.span("analyze") as asp:
                # nested syncsan/memsan windows (thread-local attribution
                # only — the outer statement keeps the trace-id registry
                # entry) so the rendered actuals carry THIS run's
                # host-boundary and device-byte counters; measurement
                # never enforces the warm budget, the outer statement
                # window does
                _ss = _syncsan.begin_statement("<analyze>")
                _ms = _memsan.begin_statement("<analyze>")
                out = to_host(self._execute_select(p, db))
                snap = _syncsan.end_statement(_ss, enforce=False)
                _ss = None
                msnap = _memsan.end_statement(_ms, enforce=False)
                _ms = None
        finally:
            if _ss is not None:
                _syncsan.discard(_ss)
            if _ms is not None:
                _memsan.discard(_ms)
        seconds = _time.monotonic() - t0
        spans = []
        if asp.recording:
            spans = subtree(
                self.cluster.tracer.spans_for(asp.trace_id),
                asp.span_id)
        profile = build_profile(
            spans, kind="explain", query_class=classify_plan(p),
            seconds=seconds, rows=out.num_rows)
        if snap is not None:
            profile.syncsan = snap
        if msnap is not None:
            profile.memsan = msnap
        return format_plan_analyzed(p, profile)

    # -- interactive transaction plumbing --

    def _no_tx(self, what: str) -> None:
        if self._tx is not None:
            self._tx_release()
            raise PlanError(
                f"{what} inside a transaction aborts it (unsupported)")

    def _tx_lock(self, name: str, t) -> None:
        if name in self._tx["locks"]:
            return
        locks = t.lock_all_shards()
        # the lock starts protecting NOW, but the tx reads the BEGIN
        # snapshot: a commit that landed in between would be silently
        # clobbered by full-row buffered writes (lost update). Close
        # the window like the statement path's lock-before-read does:
        # abort if the table moved past the snapshot before the lock.
        if any(shard.last_step > self._tx["snap"]
               for shard in t.shards):
            t.release_locks(locks)
            self._tx_release()
            raise PlanError(
                f"transaction aborted: {name} changed after BEGIN "
                "(retry the transaction)")
        self._tx["locks"][name] = locks

    def _tx_buffer(self, name: str, t, ops) -> None:
        self._tx_lock(name, t)
        entry = self._tx["ops"].setdefault(name, (t, []))
        entry[1].extend(ops)

    def _tx_release(self) -> None:
        tx, self._tx = self._tx, None
        if tx is None:
            return
        for name, locks in tx["locks"].items():
            table = self.cluster.tables.get(name)
            if table is not None:
                table.release_locks(locks)

    def _tx_commit(self):
        tx = self._tx
        if tx is None:
            raise PlanError("no open transaction")
        try:
            participants, prepare_args = [], []
            try:
                for name, (t, ops) in tx["ops"].items():
                    p, a = t.propose_ops(ops,
                                         lock_ids=tx["locks"][name])
                    participants.extend(p)
                    prepare_args.extend(a)
            except Exception:
                # a later table's propose failed: earlier tables'
                # durably staged writes must not leak in pending
                for p, a in zip(participants, prepare_args):
                    try:
                        p.abort(a)
                    except Exception:  # noqa: BLE001 - best effort
                        pass
                raise
            if not participants:
                return TxResult(0, tx["snap"], True)
            return self.cluster.coordinator.commit_volatile(
                participants, prepare_args)
        finally:
            self._tx_release()
