"""Embedded monitoring HTTP endpoint: viewer JSON APIs + whiteboard.

Mirror of the reference's monitoring plane (core/viewer/viewer.cpp
JSON handlers, core/mon/mon.cpp HTTP core, node whiteboard
tablet/node_whiteboard.cpp; SURVEY.md §2.12 row "embedded UI" and §5.5):
one HTTP listener per node serving live cluster state as JSON plus the
Prometheus counters page. Read-only: handlers snapshot cluster state
under the shared cluster lock; sys-view row materialization and JSON
encoding happen off-lock so monitoring polls stay cheap for query
traffic. When the cluster runs with auth tokens, requests must carry
``Authorization: Bearer <token>``.

Endpoints:
  /                         index (plain text listing)
  /viewer/json/cluster      cluster summary (tables/topics/storage)
  /viewer/json/scheme       scheme path tree
  /viewer/json/tables       per-table partition stats
  /viewer/json/topics       per-topic partition offsets
  /viewer/json/healthcheck  aggregated health (GOOD/DEGRADED/...)
  /viewer/json/whiteboard   per-node live snapshot (uptime, queries,
                            memory, session counts)
  /viewer/json/sysview?name=sys_query_stats   any sys view as rows
  /viewer/json/timeline     data-movement timeline summary + in-flight
                            statements; ?trace=1 = Chrome trace JSON
  /counters                 counters snapshot (JSON tree)
  /counters/prometheus      Prometheus text encoding
"""

# The port's own copy of ydb_tpu/obs/viewer.py, over the port's Cluster,
# sys views (obs/sysview.py, host numpy columns: one array per column
# per view), timeline (obs/timeline.py) and tablet counters
# (obs/tablet_counters.py). /viewer/json/topics lists the offsets of
# each partition of the cluster's topics.

from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import numpy as np

from ydb_tpu_torch.obs import sysview


def _source_rows(src) -> list[dict]:
    """Render a ColumnSource as a list of JSON-ready row dicts."""
    out = []
    n = src.num_rows
    cols = {}
    for f in src.schema.fields:
        vals = np.asarray(src.columns[f.name])
        if f.type.is_string and src.dicts is not None:
            d = src.dicts[f.name]
            cols[f.name] = [
                v.decode("utf-8", "surrogateescape")
                for v in d.decode(vals)]
        elif f.type.is_decimal:
            cols[f.name] = [int(v) / 10 ** f.type.scale for v in vals]
        else:
            cols[f.name] = [v.item() for v in vals]
    for i in range(n):
        out.append({k: v[i] for k, v in cols.items()})
    return out


class _Handler(BaseHTTPRequestHandler):
    def log_message(self, *args):  # quiet; the access log is not ours
        pass

    def do_GET(self):  # noqa: N802 - http.server API
        viewer: Viewer = self.server.viewer  # type: ignore[attr-defined]
        url = urlparse(self.path)
        if viewer.auth_tokens is not None:
            auth = self.headers.get("Authorization", "")
            token = auth[7:] if auth.startswith("Bearer ") else ""
            if token not in viewer.auth_tokens:
                self.send_error(401, "bad or missing bearer token")
                return
        try:
            body, ctype = viewer.render(url.path, parse_qs(url.query))
        except KeyError as e:
            self.send_error(404, str(e))
            return
        except Exception as e:  # noqa: BLE001 - surface, don't die
            self.send_error(500, repr(e))
            return
        self.send_response(200)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)


class Viewer:
    """Monitoring HTTP server over a Cluster."""

    def __init__(self, cluster, host: str = "127.0.0.1", port: int = 0,
                 lock: threading.Lock | None = None, node_id: int = 1,
                 auth_tokens: set[str] | None = None):
        self.cluster = cluster
        self.node_id = node_id
        self.auth_tokens = auth_tokens
        self.lock = lock if lock is not None else threading.Lock()
        self.started_at = time.time()
        self._server = ThreadingHTTPServer((host, port), _Handler)
        self._server.viewer = self  # type: ignore[attr-defined]
        self.port = self._server.server_address[1]
        self._thread: threading.Thread | None = None

    # -- lifecycle --

    def start(self) -> "Viewer":
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True,
            name="viewer-http")
        self._thread.start()
        return self

    def stop(self):
        self._server.shutdown()
        self._server.server_close()
        if self._thread:
            self._thread.join(timeout=5)

    # -- rendering --

    def render(self, path: str, query: dict) -> tuple[bytes, str]:
        if path == "/counters/prometheus":
            with self.lock:
                text = self.cluster.counters.encode_prometheus()
            return text.encode(), "text/plain; version=0.0.4"
        if path in ("/viewer", "/monitoring"):
            from ydb_tpu_torch.obs.viewer_html import PAGE

            return PAGE.encode(), "text/html; charset=utf-8"
        handlers = {
            "/": self._index,
            "/viewer/json/cluster": self._cluster,
            "/viewer/json/scheme": self._scheme,
            "/viewer/json/tables": self._tables,
            "/viewer/json/topics": self._topics,
            "/viewer/json/healthcheck": self._health,
            "/viewer/json/whiteboard": self._whiteboard,
            "/viewer/json/sysview": self._sysview,
            "/viewer/json/tablets": self._tablets,
            "/viewer/json/statistics": self._statistics,
            "/viewer/json/resident": self._resident,
            "/viewer/json/query_profile": self._query_profile,
            "/viewer/json/timeline": self._timeline,
            "/counters": self._counters,
        }
        h = handlers.get(path)
        if h is None:
            raise KeyError(f"no endpoint {path}")
        if path == "/":
            return h(query), "text/plain"
        with self.lock:
            payload = h(query)
        # sys-view handlers return a ColumnSource snapshot: its column
        # arrays are materialized (cluster no longer referenced), so the
        # O(rows) python-object conversion runs off-lock
        if hasattr(payload, "schema") and hasattr(payload, "columns"):
            payload = _source_rows(payload)
        return (json.dumps(payload, indent=1).encode(),
                "application/json")

    def _index(self, query) -> bytes:
        return __doc__.encode()

    def _cluster(self, query) -> dict:
        c = self.cluster
        return {
            "tables": sorted(c.tables),
            "topics": sorted(c.topics),
            "store": type(c.store).__name__,
            "node_id": self.node_id,
            "uptime_seconds": round(time.time() - self.started_at, 1),
        }

    def _scheme(self, query) -> list[dict]:
        out = []
        for (p,), row in self.cluster.scheme.executor.db.table(
                "paths").range():
            out.append({"path": p, "type": row["type"]})
        return out

    def _tables(self, query):
        return sysview.sys_source(self.cluster, "sys_partition_stats")

    def _topics(self, query) -> list[dict]:
        out = []
        for name, t in sorted(self.cluster.topics.items()):
            for pi, p in enumerate(t.partitions):
                out.append({
                    "topic": name, "partition": pi,
                    "start_offset": p.tail_offset,
                    "end_offset": p.head_offset,
                })
        return out

    def _health(self, query) -> dict:
        return sysview.health_check(self.cluster)

    def _whiteboard(self, query) -> dict:
        """Per-node live snapshot (node_whiteboard.cpp:23 analog)."""
        from ydb_tpu_torch.obs.probes import memory_stats

        c = self.cluster
        qlog = list(c.query_log)[-10:]
        return {
            "node_id": self.node_id,
            "uptime_seconds": round(time.time() - self.started_at, 1),
            "tables": len(c.tables),
            "topics": len(c.topics),
            "recent_queries": [
                {"sql": q["sql"][:120], "kind": q["kind"],
                 "duration_us": int(q["seconds"] * 1e6)}
                for q in qlog],
            "memory": {k: v for k, v in memory_stats().items()
                       if v is not None},
        }

    def _sysview(self, query):
        names = query.get("name")
        if not names:
            return sorted(sysview.SYS_SCHEMAS)
        return sysview.sys_source(self.cluster, names[0])

    def _resident(self, query) -> dict:
        """HBM-resident column tier (engine/resident.py): per-shard
        pinned bytes vs budget plus the promotion/eviction lifecycle —
        whether the hot set is actually resident, and what pressure is
        doing to it."""
        rows = _source_rows(
            sysview.sys_source(self.cluster, "sys_resident_store"))
        total = {"bytes": 0, "budget": 0, "portions": 0,
                 "promotions": 0, "evictions": 0, "spills": 0,
                 "hits": 0, "misses": 0}
        for r in rows:
            for k in total:
                total[k] += r.get(k, 0)
        return {"shards": rows, "total": total}

    def _statistics(self, query) -> dict:
        """Column statistics + scan-pruning effectiveness (the stats
        subsystem's monitoring face): table NDV/null fractions from the
        aggregator and per-shard pruning counters, so a pruning
        regression is visible without a bench run."""
        return {
            "columns": _source_rows(
                sysview.sys_source(self.cluster, "sys_statistics")),
            "pruning": _source_rows(
                sysview.sys_source(self.cluster, "sys_scan_pruning")),
        }

    def _query_profile(self, query) -> dict:
        """Per-query profiles from the bounded ring (the top-queries /
        EXPLAIN-ANALYZE data over HTTP): the N most expensive recent
        queries plus the latest profile with its full span tree.
        ``?seq=N`` selects one profile by ring sequence number."""
        ring = self.cluster.profiles
        seqs = query.get("seq")
        if seqs:
            want = int(seqs[0])
            for p in ring.recent():
                if p.seq == want:
                    return dict(p.to_dict(), span_tree=p.span_tree())
            raise KeyError(f"no profile seq={want}")
        recent = ring.recent()
        last = recent[-1] if recent else None
        return {
            "top": [p.to_dict() for p in ring.top(16)],
            "recent": [
                {"seq": p.seq, "query_text": p.sql[:120],
                 "kind": p.kind, "query_class": p.query_class,
                 "seconds": round(p.seconds, 6), "rows": p.rows}
                for p in recent],
            "last": (dict(last.to_dict(), span_tree=last.span_tree())
                     if last is not None else None),
        }

    def _timeline(self, query) -> dict:
        """Data-movement timeline (obs.timeline): ring summary with
        per-category busy seconds, movement byte counters and the
        in-flight statement list; ``?trace=1`` returns the full
        Chrome/Perfetto trace_event JSON instead (save it and open in
        chrome://tracing or https://ui.perfetto.dev)."""
        from ydb_tpu_torch.obs import timeline

        if query.get("trace", ["0"])[0] not in ("", "0"):
            return timeline.export_chrome_trace()
        out = timeline.summary()
        out["active_queries"] = self.cluster.active_query_snapshot()
        return out

    def _tablets(self, query) -> dict:
        """Per-tablet counters + per-type aggregates (the counters-
        aggregator merge, tablet_counters_aggregator.cpp)."""
        from ydb_tpu_torch.obs import tablet_counters

        rows = tablet_counters.collect(self.cluster)
        return {
            "tablets": rows,
            "aggregates": tablet_counters.aggregate(
                self.cluster, rows),
        }

    def _counters(self, query) -> dict:
        return self.cluster.counters.snapshot()
