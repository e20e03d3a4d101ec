"""StatisticsAggregator: per-shard sketches folded into table stats.

The port's own copy of ``ydb_tpu/stats/aggregator.py``, with its
tracked lock, shared maps and ``stats.aggregator.refresh`` probe. Mirror
of the reference's statistics aggregator tablet
(ydb/core/statistics/aggregator/aggregator_impl.h; SURVEY.md §2.7): a
service that periodically — and on demand after commit/compaction
events — pulls per-shard column sketches, merges them into table-level
``TableStats`` and serves them to the planner. Durability rides the
tablet WAL machinery (``tablet/executor.py``, the reference's table name
and JSON): merged stats snapshot into the executor's local DB, so a
rebooted node (of either package) plans with its persisted statistics
instead of none while the first refresh runs.

Collection is incremental: per-(shard, portion) sketches cache in
memory keyed by the immutable portion id, so a refresh only reads
chunks of portions it has never seen; entries of GC'd portions prune.
Memory stays bounded by the live portion count, reads stay bounded by
churn, and the scan path is never touched (stats read blobs directly,
chunk at a time).
"""

from __future__ import annotations

import json
import threading

from ydb_tpu_torch.analysis import sanitizer
from ydb_tpu_torch.obs.probes import probe
from ydb_tpu_torch.stats.cost import ColumnStats, TableStats
from ydb_tpu_torch.stats.sketch import ColumnSketch

_P_REFRESH = probe("stats.aggregator.refresh")


class StatisticsAggregator:
    """Merges per-portion column sketches into table-level statistics.

    ``store`` (optional) enables snapshot/restore through a
    TabletExecutor on that blob store; without it the aggregator is a
    purely in-memory cache. ``start(period, fn)`` runs ``fn`` (the
    owner's refresh closure) on a background thread until ``stop()`` —
    the owner decides WHAT to refresh, the aggregator owns cadence and
    thread lifecycle.
    """

    def __init__(self, store=None, tablet_id: str = "statsaggr"):
        name = f"statsaggr.{id(self):x}"
        self._lock = sanitizer.make_lock(f"{name}.lock")
        # (shard_id, portion_id) -> {column: ColumnSketch}
        self._portions = sanitizer.share({}, f"{name}.portions")
        self._tables = sanitizer.share({}, f"{name}.tables")
        # table -> visible-portion-set fingerprint of the last refresh:
        # a steady-state maintenance tick (nothing committed/compacted)
        # must not re-merge every sketch nor rewrite the WAL snapshot
        self._table_keys = sanitizer.share({}, f"{name}.table_keys")
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self.executor = None
        if store is not None:
            from ydb_tpu_torch.tablet.executor import TabletExecutor

            self.executor = TabletExecutor.boot(tablet_id, store)
            restored = {}
            for (tname,), row in self.executor.db.table(
                    "table_stats").range():
                restored[tname] = TableStats.from_json(
                    json.loads(row["json"]))
            with self._lock:
                self._tables.update(restored)

    # ---- collection ----

    def _portion_sketches(self, shard, meta) -> dict:
        """Sketches for ONE portion, chunk-streamed (bounded memory)."""
        from ydb_tpu_torch.engine.portion import PortionChunkReader

        rd = PortionChunkReader(shard.store, meta.blob_id)
        out: dict[str, ColumnSketch] = {}
        for i in range(rd.n_chunks):
            cols, valid = rd.read_chunk(i)
            for col, arr in cols.items():
                sk = out.get(col)
                if sk is None:
                    sk = out[col] = ColumnSketch()
                sk.observe(arr, valid.get(col))
        return out

    def collect_shard(self, shard) -> dict:
        """Per-column merged sketches over a shard's visible portions;
        per-portion results cache by immutable portion id."""
        metas = shard.visible_portions()
        fresh: dict = {}
        todo = []
        with self._lock:
            for m in metas:
                key = (shard.shard_id, m.portion_id)
                hit = self._portions.get(key)
                if hit is None:
                    todo.append(m)
                else:
                    fresh[key] = hit
        # chunk reads happen OFF the lock (blob IO must not serialize
        # against concurrent stat lookups)
        computed = {(shard.shard_id, m.portion_id):
                    self._portion_sketches(shard, m) for m in todo}
        with self._lock:
            self._portions.update(computed)
            # prune entries of portions no longer in the shard's map
            live = {(shard.shard_id, m.portion_id) for m in metas}
            dead = [k for k in self._portions
                    if k[0] == shard.shard_id and k not in live]
            for k in dead:
                del self._portions[k]
        fresh.update(computed)
        merged: dict[str, ColumnSketch] = {}
        for sketches in fresh.values():
            for col, sk in sketches.items():
                merged[col] = sk if col not in merged \
                    else merged[col].merge(sk)
        return merged

    def refresh_table(self, name: str, shards) -> TableStats:
        """Pull + merge one table's shard sketches into TableStats and
        persist the snapshot. No-ops (serving the cached snapshot) when
        the table's visible portion set is unchanged since the last
        refresh — the steady-state maintenance tick costs one metadata
        walk, not a re-merge."""
        col_shards = [s for s in shards if hasattr(s, "visible_portions")]
        key = tuple(
            (s.shard_id, tuple(m.portion_id
                               for m in s.visible_portions()))
            for s in col_shards)
        with self._lock:
            cached = self._tables.get(name)
            if cached is not None and self._table_keys.get(name) == key:
                return cached
        merged: dict[str, ColumnSketch] = {}
        rows = 0
        for s in col_shards:
            rows += sum(m.num_rows for m in s.visible_portions())
            for col, sk in self.collect_shard(s).items():
                merged[col] = sk if col not in merged \
                    else merged[col].merge(sk)
        stats = TableStats(rows=rows, columns={
            col: ColumnStats(ndv=sk.ndv, nulls=sk.nulls, rows=sk.rows,
                             vmin=sk.vmin, vmax=sk.vmax,
                             heavy=sk.max_freq)
            for col, sk in merged.items()
        })
        with self._lock:
            self._tables[name] = stats
            self._table_keys[name] = key
        if self.executor is not None:
            payload = json.dumps(stats.to_json())
            self.executor.run(
                lambda txc: txc.put("table_stats", (name,),
                                    {"json": payload}))
        if _P_REFRESH:
            _P_REFRESH.fire(table=name, rows=rows,
                            columns=len(stats.columns))
        return stats

    def refresh_tables(self, tables: dict) -> dict:
        """tables: name -> shard list. Returns name -> TableStats."""
        return {name: self.refresh_table(name, shards)
                for name, shards in tables.items()}

    def refresh_cluster(self, cluster) -> dict:
        """Refresh every column-store table of a Cluster."""
        return self.refresh_tables({
            name: list(getattr(t, "shards", ()))
            for name, t in cluster.tables.items()
        })

    # ---- serving ----

    def table_stats(self, name: str) -> TableStats | None:
        with self._lock:
            return self._tables.get(name)

    def all_stats(self) -> dict:
        with self._lock:
            return dict(self._tables)

    def forget(self, name: str, shard_ids=()) -> None:
        """Drop a table's stats (DROP TABLE). ``shard_ids`` purges the
        per-portion sketch cache too: a re-created same-name table
        reuses shard ids AND restarts portion ids at 1 (the same hazard
        the cluster scan cache documents), so stale entries would serve
        the dropped table's sketches as the new table's statistics."""
        with self._lock:
            self._tables.pop(name, None)
            self._table_keys.pop(name, None)
            drop = set(shard_ids)
            if drop:
                for k in [k for k in self._portions if k[0] in drop]:
                    del self._portions[k]
        if self.executor is not None:
            self.executor.run(
                lambda txc: txc.erase("table_stats", (name,)))

    # ---- cadence ----

    def start(self, period_s: float, refresh_fn) -> None:
        """Background refresh every ``period_s`` seconds until stop().
        ``refresh_fn()`` is the owner's closure (e.g. bound
        ``refresh_cluster``); its errors are swallowed so a transient
        storage hiccup never kills the cadence thread."""
        if self._thread is not None:
            return

        def loop():
            while not self._stop.wait(timeout=period_s):
                try:
                    refresh_fn()
                except Exception:  # noqa: BLE001 - cadence must survive
                    pass

        self._thread = threading.Thread(
            target=loop, daemon=True, name="stats-aggregator")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=5)
            self._thread = None
        self._stop = threading.Event()
