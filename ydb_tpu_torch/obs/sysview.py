"""System views + health check.

Mirror of the reference's sys_view providers (`SELECT ... FROM .sys
tables`: partition_stats, query_stats, nodes — core/sys_view;
SURVEY.md §2.14) and the health-check service
(core/health_check/health_check.cpp): live cluster state exposed
through the NORMAL query path — sys tables materialize as ColumnSources
injected into the snapshot database, so the planner/executor treat
them like any table (dots become underscores: sys_partition_stats).

The port's own copy of ``ydb_tpu/obs/sysview.py``, over the port's
``Cluster`` (``kqp/session.py``). Every view's columns are host numpy
arrays; a statement stages them to its device like any other source.
String cells intern into ``cluster.dicts`` in the reference's order, so
after the same statements the dictionary ids are the reference's.
``table_stats`` (cheap: portion metadata only) also feeds the planner's
row counts and load-driven resharding. ``health_check`` reads a
``GroupBlobStore``'s disks when the store has a ``proxy``
(``ydb_tpu_torch/blobstorage``): a group with disks down is DEGRADED, one
past its loss tolerance EMERGENCY.
"""

from __future__ import annotations

import numpy as np

from ydb_tpu_torch import dtypes
from ydb_tpu_torch.engine.scan import ColumnSource


SYS_SCHEMAS = {
    "sys_partition_stats": dtypes.schema(
        ("table_name", dtypes.STRING), ("shard", dtypes.INT32),
        ("store", dtypes.STRING), ("rows", dtypes.INT64),
        ("portions", dtypes.INT32)),
    "sys_query_stats": dtypes.schema(
        ("query_text", dtypes.STRING), ("kind", dtypes.STRING),
        ("duration_us", dtypes.INT64), ("result_rows", dtypes.INT64)),
    "sys_scheme_paths": dtypes.schema(
        ("path", dtypes.STRING), ("kind", dtypes.STRING)),
    # statistics service analog (ydb/core/statistics): per-table stats
    # for cost-based planning, collected from portion metadata (cheap —
    # no scan)
    "sys_table_stats": dtypes.schema(
        ("table_name", dtypes.STRING), ("rows", dtypes.INT64),
        ("portions", dtypes.INT64), ("pk_min", dtypes.INT64),
        ("pk_max", dtypes.INT64)),
    # audit log (ydb/core/audit): state-changing statements
    "sys_audit": dtypes.schema(
        ("kind", dtypes.STRING), ("sql", dtypes.STRING),
        ("status", dtypes.STRING), ("duration_us", dtypes.INT64)),
    # memory observability (memory profiling row): process + device
    "sys_memory": dtypes.schema(
        ("metric", dtypes.STRING), ("value", dtypes.DOUBLE)),
    # per-tablet executor counters (tablet_counters_aggregator feed)
    "sys_tablet_counters": dtypes.schema(
        ("tablet_id", dtypes.STRING), ("type", dtypes.STRING),
        ("generation", dtypes.INT32), ("tx_executed", dtypes.INT64),
        ("tx_committed", dtypes.INT64), ("redo_bytes", dtypes.INT64),
        ("checkpoints", dtypes.INT64)),
    # column statistics (StatisticsAggregator feed, ydb/core/statistics
    # analog): table-level NDV / null fractions / physical value bounds
    # per column — what the planner's estimates are built from
    "sys_statistics": dtypes.schema(
        ("table_name", dtypes.STRING), ("column_name", dtypes.STRING),
        ("ndv", dtypes.INT64), ("null_fraction", dtypes.DOUBLE),
        ("rows", dtypes.INT64), ("vmin", dtypes.DOUBLE),
        ("vmax", dtypes.DOUBLE)),
    # per-shard scan-pruning effectiveness (cumulative since boot):
    # pruning regressions show here without a bench run
    "sys_scan_pruning": dtypes.schema(
        ("table_name", dtypes.STRING), ("shard", dtypes.INT32),
        ("scans", dtypes.INT64), ("portions_total", dtypes.INT64),
        ("portions_skipped", dtypes.INT64),
        ("chunks_read", dtypes.INT64), ("chunks_skipped", dtypes.INT64),
        ("chunks_fastpath", dtypes.INT64),
        ("filters_dropped", dtypes.INT64)),
    # the N most expensive recent queries with their profiles (the
    # reference's .sys/top_queries): backed by the bounded profile ring
    "sys_top_queries": dtypes.schema(
        ("rank", dtypes.INT32), ("query_text", dtypes.STRING),
        ("kind", dtypes.STRING), ("query_class", dtypes.STRING),
        ("seconds", dtypes.DOUBLE), ("rows", dtypes.INT64),
        ("compile_seconds", dtypes.DOUBLE),
        ("execute_seconds", dtypes.DOUBLE),
        ("plan_cache", dtypes.STRING), ("compile_cache", dtypes.STRING),
        ("read_seconds", dtypes.DOUBLE),
        ("merge_seconds", dtypes.DOUBLE),
        ("stage_seconds", dtypes.DOUBLE),
        ("compute_seconds", dtypes.DOUBLE),
        ("portions_skipped", dtypes.INT64),
        ("chunks_read", dtypes.INT64),
        ("chunks_skipped", dtypes.INT64),
        ("error", dtypes.INT32),
        ("error_reason", dtypes.STRING),
        ("batch_id", dtypes.INT64), ("batch_size", dtypes.INT32),
        ("shared_scan", dtypes.INT32), ("tenant", dtypes.STRING)),
    # HBM-resident column tier (engine/resident.py): per-shard pinned
    # bytes vs budget plus promotion/eviction/spill lifecycle counters
    # — the "is the hot set actually resident" dashboard
    "sys_resident_store": dtypes.schema(
        ("table_name", dtypes.STRING), ("shard", dtypes.INT32),
        ("enabled", dtypes.INT32), ("portions", dtypes.INT64),
        ("columns", dtypes.INT64), ("bytes", dtypes.INT64),
        ("budget", dtypes.INT64), ("hits", dtypes.INT64),
        ("misses", dtypes.INT64), ("promotions", dtypes.INT64),
        ("evictions", dtypes.INT64), ("spills", dtypes.INT64),
        ("invalidations", dtypes.INT64), ("errors", dtypes.INT64),
        ("inflight", dtypes.INT64)),
    # recent queries in arrival order with profile summaries (the
    # profile-ring twin of sys_query_stats, which stays text-only)
    "sys_query_log": dtypes.schema(
        ("seq", dtypes.INT64), ("query_text", dtypes.STRING),
        ("kind", dtypes.STRING), ("query_class", dtypes.STRING),
        ("seconds", dtypes.DOUBLE), ("rows", dtypes.INT64),
        ("trace_id", dtypes.INT64), ("spans", dtypes.INT64)),
    # live in-flight statements (the reference's .sys running-queries
    # introspection): fed by the Cluster active-query registry, which
    # sessions enter before admission and leave on completion/failure
    "sys_active_queries": dtypes.schema(
        ("query_text", dtypes.STRING), ("kind", dtypes.STRING),
        ("stage", dtypes.STRING), ("elapsed_seconds", dtypes.DOUBLE),
        ("rows", dtypes.INT64), ("queue_position", dtypes.INT32),
        ("trace_id", dtypes.INT64),
        ("batch_id", dtypes.INT64), ("batch_size", dtypes.INT32),
        ("shared_scan", dtypes.INT32), ("tenant", dtypes.STRING)),
    # device-memory footprint ledger (analysis.memsan,
    # YDB_TPU_MEMSAN=1): per-component live/peak HBM bytes plus
    # charge/release/eviction lifecycle counters, with a "<global>"
    # row carrying the process-wide peak and armed budget — the "where
    # did the HBM go" dashboard; empty while the sanitizer is off
    "sys_device_memory": dtypes.schema(
        ("component", dtypes.STRING), ("live_bytes", dtypes.INT64),
        ("peak_bytes", dtypes.INT64), ("charges", dtypes.INT64),
        ("releases", dtypes.INT64), ("evictions", dtypes.INT64)),
    # the front door's workload pools (serving/): per-tenant weights,
    # budget shares and admission counters — the ".sys resource pools"
    # dashboard an operator reads during an overload
    "sys_tenant_pools": dtypes.schema(
        ("tenant", dtypes.STRING), ("weight", dtypes.DOUBLE),
        ("inflight", dtypes.INT32), ("max_inflight", dtypes.INT32),
        ("queued", dtypes.INT32), ("queue_size", dtypes.INT32),
        ("admitted", dtypes.INT64), ("shed", dtypes.INT64),
        ("pool_limit", dtypes.INT32),
        ("conveyor_workers", dtypes.INT32),
        ("resident_bytes", dtypes.INT64)),
}


def _source(name: str, rows, dicts) -> ColumnSource:
    """rows: per-column python lists, ordered per SYS_SCHEMAS[name]."""
    schema = SYS_SCHEMAS[name]
    arrays = {}
    for f, values in zip(schema.fields, rows):
        if f.type.is_string:
            d = dicts.for_column(f.name)
            arrays[f.name] = np.asarray(
                [d.add(v.encode() if isinstance(v, str) else v)
                 for v in values], dtype=np.int32)
        else:
            arrays[f.name] = np.asarray(values, dtype=f.type.physical)
    return ColumnSource(arrays, schema, dicts)


def _partition_stats_rows(cluster):
    names, shards, kinds, rows_c, extra = [], [], [], [], []
    for tname, t in cluster.tables.items():
        for i, s in enumerate(t.shards):
            names.append(tname)
            shards.append(i)
            if hasattr(s, "portions"):  # ColumnShard
                kinds.append("column")
                vis = s.visible_portions()
                rows_c.append(int(sum(p.num_rows for p in vis)))
                extra.append(len(vis))
            else:                        # DataShard
                kinds.append("row")
                n = sum(len(page) for page in s.read(s.last_step))
                rows_c.append(n)
                extra.append(0)
    return [names, shards, kinds, rows_c, extra]


def _query_stats_rows(cluster):
    log = list(cluster.query_log)
    return [[q["sql"][:256] for q in log], [q["kind"] for q in log],
            [int(q["seconds"] * 1e6) for q in log],
            [q["rows"] for q in log]]


def _scheme_paths_rows(cluster):
    paths, kinds = [], []
    for (p,), row in cluster.scheme.executor.db.table("paths").range():
        paths.append(p)
        kinds.append(row["type"])
    return [paths, kinds]


def table_stats(cluster, cheap: bool = True) -> dict[str, dict]:
    """Per-table statistics from portion metas (the statistics-service
    collection path): row counts + PK bounds; feeds CBO join ordering
    (Catalog.row_counts) and the sys_table_stats view.

    ``cheap`` (the per-plan CBO feed) reads column-shard portion
    METADATA only; row tables report rows=0 (unknown) rather than
    paying a full page walk on every statement plan. The sys view
    passes cheap=False for exact counts."""
    out: dict[str, dict] = {}
    for tname, t in cluster.tables.items():
        rows = 0
        unknown = False
        portions = 0
        pk_min = pk_max = None
        for s in t.shards:
            if not hasattr(s, "portions"):
                if cheap:
                    unknown = True  # no metadata count for row tables
                else:
                    # row table: page walk (exact, O(rows))
                    rows += sum(
                        len(page) for page in s.read(s.last_step))
                continue
            for m in s.visible_portions():
                rows += m.num_rows
                portions += 1
                if m.pk_min is not None:
                    pk_min = (m.pk_min if pk_min is None
                              else min(pk_min, m.pk_min))
                if m.pk_max is not None:
                    pk_max = (m.pk_max if pk_max is None
                              else max(pk_max, m.pk_max))
        out[tname] = {"rows": None if unknown else rows,
                      "portions": portions,
                      "pk_min": pk_min, "pk_max": pk_max}
    return out


def _table_stats_rows(cluster):
    st = table_stats(cluster, cheap=False)
    names = sorted(st)
    return [
        names,
        [st[n]["rows"] for n in names],
        [st[n]["portions"] for n in names],
        [st[n]["pk_min"] or 0 for n in names],
        [st[n]["pk_max"] or 0 for n in names],
    ]


def _audit_rows(cluster):
    log = list(cluster.audit_log)
    return [[a["kind"] for a in log], [a["sql"] for a in log],
            [a["status"] for a in log],
            [a["duration_us"] for a in log]]


def _memory_rows(cluster):
    from ydb_tpu_torch.obs.probes import memory_stats

    st = memory_stats()
    keys = sorted(k for k, v in st.items() if v is not None)
    return [keys, [float(st[k]) for k in keys]]


def _tablet_counters_rows(cluster):
    from ydb_tpu_torch.obs.tablet_counters import collect

    rows = collect(cluster)
    return [[r["tablet_id"] for r in rows],
            [r["type"] for r in rows],
            [r["generation"] for r in rows],
            [r["tx_executed"] for r in rows],
            [r["tx_committed"] for r in rows],
            [r["redo_bytes"] for r in rows],
            [r["checkpoints"] for r in rows]]


def _statistics_rows(cluster):
    """Aggregator column statistics; refreshes tables with no cached
    stats yet (first read after boot) but serves cached snapshots
    otherwise — the run_background cadence owns recomputation."""
    stats = cluster.stats.all_stats()
    missing = {
        name: list(getattr(t, "shards", ()))
        for name, t in cluster.tables.items()
        if name not in stats and hasattr(t, "shards")
        and any(hasattr(s, "portions") for s in t.shards)
    }
    if missing:
        stats.update(cluster.stats.refresh_tables(missing))
    tables, columns, ndv, nullf, rows, vmin, vmax = \
        [], [], [], [], [], [], []
    for tname in sorted(stats):
        st = stats[tname]
        for col in sorted(st.columns):
            cs = st.columns[col]
            tables.append(tname)
            columns.append(col)
            ndv.append(cs.ndv)
            nullf.append(cs.null_fraction)
            rows.append(cs.rows)
            vmin.append(float(cs.vmin) if cs.vmin is not None else 0.0)
            vmax.append(float(cs.vmax) if cs.vmax is not None else 0.0)
    return [tables, columns, ndv, nullf, rows, vmin, vmax]


def _scan_pruning_rows(cluster):
    cols: list[list] = [[] for _ in range(9)]
    for tname, t in cluster.tables.items():
        for i, s in enumerate(getattr(t, "shards", ())):
            totals = getattr(s, "pruning_totals", None)
            if totals is None:
                continue
            lock = getattr(s, "_stats_lock", None)
            if lock is not None:
                with lock:
                    snap = dict(totals)
            else:
                snap = dict(totals)
            row = [tname, i, snap["scans"], snap["portions_total"],
                   snap["portions_skipped"], snap["chunks_read"],
                   snap["chunks_skipped"], snap["chunks_fastpath"],
                   snap["filters_dropped"]]
            for c, v in zip(cols, row):
                c.append(v)
    return cols


def _top_queries_rows(cluster):
    cols: list[list] = [[] for _ in range(23)]
    for rank, p in enumerate(cluster.profiles.top(16), start=1):
        st = p.stages
        pr = p.pruning
        row = [rank, p.sql[:256], p.kind, p.query_class,
               p.seconds, p.rows, p.compile_seconds, p.execute_seconds,
               p.plan_cache or "", p.compile_cache or "",
               st.get("read", 0.0), st.get("merge", 0.0),
               st.get("stage", 0.0), st.get("compute", 0.0),
               pr.get("portions_skipped", 0), pr.get("chunks_read", 0),
               pr.get("chunks_skipped", 0), getattr(p, "error", 0),
               getattr(p, "error_reason", ""),
               getattr(p, "batch_id", 0), getattr(p, "batch_size", 0),
               getattr(p, "shared_scan", 0), getattr(p, "tenant", "")]
        for c, v in zip(cols, row):
            c.append(v)
    return cols


def _resident_store_rows(cluster):
    cols: list[list] = [[] for _ in range(15)]
    for tname, t in cluster.tables.items():
        for i, s in enumerate(t.shards):
            store = getattr(s, "resident", None)
            if store is None:  # DataShard
                continue
            snap = store.snapshot()
            row = [tname, i, int(store.enabled()), snap["portions"],
                   snap["columns"], snap["bytes"], snap["budget"],
                   snap["hits"], snap["misses"], snap["promotions"],
                   snap["evictions"], snap["spills"],
                   snap["invalidations"], snap["errors"],
                   snap["inflight"]]
            for c, v in zip(cols, row):
                c.append(v)
    return cols


def _active_queries_rows(cluster):
    cols: list[list] = [[] for _ in range(11)]
    for e in cluster.active_query_snapshot():
        row = [e["sql"][:256], e["kind"], e["stage"],
               e["elapsed_seconds"], e["rows"], e["queue_position"],
               e["trace_id"], e.get("batch_id", 0),
               e.get("batch_size", 0), e.get("shared_scan", 0),
               e.get("tenant", "")]
        for c, v in zip(cols, row):
            c.append(v)
    return cols


def _tenant_pools_rows(cluster):
    cols: list[list] = [[] for _ in range(11)]
    fd = getattr(cluster, "front_door", None)
    if fd is None:
        return cols  # no front door: the view exists but is empty
    for name, row in fd.snapshot().items():
        vals = [name, row["weight"], row["inflight"],
                row["max_inflight"], row["queued"], row["queue_size"],
                row["admitted"], row["shed"], row["pool_limit"],
                row["conveyor_workers"], row["resident_bytes"]]
        for c, v in zip(cols, vals):
            c.append(v)
    return cols


def _device_memory_rows(cluster):
    from ydb_tpu_torch.analysis import memsan

    cols: list[list] = [[] for _ in range(6)]
    if not memsan.armed():
        return cols  # sanitizer off: the view exists but is empty
    totals = memsan.component_totals()
    for comp in sorted(totals):
        t = totals[comp]
        row = [comp, t["live"], t["peak"], t["charges"],
               t["releases"], t["evictions"]]
        for c, v in zip(cols, row):
            c.append(v)
    live = sum(t["live"] for t in totals.values())
    charges = sum(t["charges"] for t in totals.values())
    releases = sum(t["releases"] for t in totals.values())
    evictions = sum(t["evictions"] for t in totals.values())
    row = ["<global>", live, memsan.global_peak(), charges, releases,
           evictions]
    for c, v in zip(cols, row):
        c.append(v)
    return cols


def _query_log_rows(cluster):
    cols: list[list] = [[] for _ in range(8)]
    for p in cluster.profiles.recent():
        row = [p.seq, p.sql[:256], p.kind, p.query_class, p.seconds,
               p.rows, p.trace_id, len(p.spans)]
        for c, v in zip(cols, row):
            c.append(v)
    return cols


_BUILDERS = {
    "sys_partition_stats": _partition_stats_rows,
    "sys_query_stats": _query_stats_rows,
    "sys_scheme_paths": _scheme_paths_rows,
    "sys_table_stats": _table_stats_rows,
    "sys_audit": _audit_rows,
    "sys_memory": _memory_rows,
    "sys_tablet_counters": _tablet_counters_rows,
    "sys_statistics": _statistics_rows,
    "sys_scan_pruning": _scan_pruning_rows,
    "sys_resident_store": _resident_store_rows,
    "sys_device_memory": _device_memory_rows,
    "sys_top_queries": _top_queries_rows,
    "sys_query_log": _query_log_rows,
    "sys_active_queries": _active_queries_rows,
    "sys_tenant_pools": _tenant_pools_rows,
}


def sys_source(cluster, name: str) -> ColumnSource:
    """Materialize ONE sys view (each has its own cost; the lazy source
    map builds only what a query touches)."""
    return _source(name, _BUILDERS[name](cluster), cluster.dicts)


def sys_sources(cluster) -> dict[str, ColumnSource]:
    return {name: sys_source(cluster, name) for name in SYS_SCHEMAS}


def health_check(cluster) -> dict:
    """Aggregated health (health_check.cpp analog): GOOD | DEGRADED |
    EMERGENCY plus per-issue detail."""
    issues = []
    # storage probe: write/read/delete a canary blob
    try:
        cluster.store.put("health/canary", b"ok")
        if cluster.store.get("health/canary") != b"ok":
            issues.append({"severity": "red",
                           "message": "storage canary mismatch"})
        cluster.store.delete("health/canary")
    except Exception as e:  # noqa: BLE001
        issues.append({"severity": "red",
                       "message": f"storage unavailable: {e}"})
    # degraded erasure groups (when running on a GroupBlobStore)
    proxy = getattr(cluster.store, "proxy", None)
    if proxy is not None:
        down = sum(1 for d in proxy.group.disks if d.down)
        if down:
            sev = ("red" if down > proxy.codec.max_lost else "yellow")
            issues.append({
                "severity": sev,
                "message": f"group {proxy.group.group_id}: {down} "
                           f"disk(s) down",
            })
    # scheme/table agreement
    for desc in cluster.scheme.list_tables():
        if desc.path.strip("/") not in cluster.tables:
            issues.append({
                "severity": "yellow",
                "message": f"table {desc.path} in scheme but not "
                           f"instantiated",
            })
    if any(i["severity"] == "red" for i in issues):
        status = "EMERGENCY"
    elif issues:
        status = "DEGRADED"
    else:
        status = "GOOD"
    return {"status": status, "issues": issues}
