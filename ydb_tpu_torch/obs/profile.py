"""Per-query profiles assembled from finished span trees.

The reference surfaces query runtime statistics three ways — the plan
annotated with actuals (``EXPLAIN ANALYZE`` / execution stats in the
query response), ``.sys/top_queries`` + ``.sys/query_metrics`` views
over an in-memory ring of the most expensive recent queries, and
per-pool latency histograms on the counters page (SURVEY.md §2.14,
§5.5). This module is that layer for this database: the session runs
every statement under a traced root span (obs.tracing), the executor /
scan / DQ / conveyor layers attach children, and ``build_profile``
folds the finished tree into one ``QueryProfile`` — per-stage seconds,
device vs host time, rows, cache hits, compile-vs-execute split — that
feeds ``session.last_profile``, the ``sys_top_queries`` /
``sys_query_log`` views, the ``/viewer/json/query_profile`` endpoint
and ``EXPLAIN ANALYZE`` rendering.

The port's own copy of ``ydb_tpu/obs/profile.py``, built from the port's
spans; ``compile_cache`` reads the hits and misses of the port's
``Database._compile_cache`` from the ``scan``, ``transform`` and
``plan.fuse`` spans. Left out: the timeline ring's stage occupancy
(ROADMAP.md queue A, tracing).
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
import time


#: span attrs summed into the per-query stage breakdown; "compute" is
#: device time, the rest is host-side pipeline work
STAGE_KEYS = ("read", "merge", "stage", "compute")
#: span attrs summed into the per-query pruning/row accounting
PRUNING_KEYS = ("portions_total", "portions_skipped", "chunks_read",
                "chunks_skipped", "resident_portions", "resident_rows")
#: span names that carry scan-level stage/pruning/compile attrs
SCAN_SPANS = ("scan", "shard.scan")


@dataclasses.dataclass
class QueryProfile:
    """One query's assembled execution profile."""

    sql: str = ""
    kind: str = ""
    query_class: str = ""
    trace_id: int = 0
    seq: int = 0
    seconds: float = 0.0
    rows: int = 0
    plan_cache: str = ""      # hit | miss | "" (unknown/disabled)
    compile_cache: str = ""   # miss if ANY scan/transform compiled fresh
    compile_seconds: float = 0.0   # lowering + first trace or capture
    execute_seconds: float = 0.0   # seconds - compile_seconds
    fused_stages: int = 0     # plan nodes folded into one traced dispatch
    fragments_elided: int = 0  # dispatch boundaries removed by fusion
    #: cross-query batching (kqp/batch.py): group id + member count of
    #: the micro-batch that served this statement (0 = unbatched), how
    #: many of its scan sites were served by a staging shared with
    #: batchmates, and the wait-for-window vs shared-execute split
    batch_id: int = 0
    batch_size: int = 0
    shared_scan: int = 0
    batch_wait_seconds: float = 0.0
    batch_execute_seconds: float = 0.0
    stages: dict = dataclasses.field(default_factory=dict)
    pruning: dict = dataclasses.field(default_factory=dict)
    #: host-boundary counters from the sync sanitizer
    #: (analysis.syncsan, YDB_TPU_TORCH_SYNCSAN=1): h2d/d2h copies, the
    #: seams' syncs and the CUDA debug mode's, graph captures, kernel
    #: builds and compile_program calls this statement crossed; {} when
    #: the sanitizer is off
    syncsan: dict = dataclasses.field(default_factory=dict)
    #: device-byte counters from the footprint sanitizer
    #: (analysis.memsan, YDB_TPU_TORCH_MEMSAN=1): peak/live device
    #: bytes, charge count and unbudgeted allocations this statement
    #: made; {} when the sanitizer is off
    memsan: dict = dataclasses.field(default_factory=dict)
    device_seconds: float = 0.0
    host_seconds: float = 0.0
    #: per-stage busy fractions + overlap coefficients from the
    #: data-movement timeline (obs.timeline); {} when the ring is off
    stage_occupancy: dict = dataclasses.field(default_factory=dict)
    #: 1 when the statement failed mid-execution (the profile still
    #: lands in the ring so slow-then-failing statements stay visible)
    error: int = 0
    #: why it failed: "cancelled" (deadline), "overloaded" (admission
    #: shed), else the error type name; "" on success
    error_reason: str = ""
    #: workload pool the statement admitted under (serving/tenants.py);
    #: "" for sessions on clusters without a front door
    tenant: str = ""
    spans: list = dataclasses.field(default_factory=list)

    def to_dict(self, include_spans: bool = False) -> dict:
        """JSON-ready summary. Spans are excluded by default — every
        current consumer (bench extras, the viewer's top-N list) wants
        the summary, and span detail is served separately as a tree
        (``span_tree``) — only ``include_spans=True`` ships the raw
        list."""
        d = dataclasses.asdict(self)
        if not include_spans:
            del d["spans"]
            d["span_count"] = len(self.spans)
        d["seconds"] = round(self.seconds, 6)
        d["compile_seconds"] = round(self.compile_seconds, 6)
        d["execute_seconds"] = round(self.execute_seconds, 6)
        return d

    def span_tree(self) -> list[dict]:
        """Spans nested children-under-parents (forest of roots)."""
        by_id = {s["span_id"]: dict(s, children=[]) for s in self.spans}
        roots = []
        for s in by_id.values():
            parent = by_id.get(s["parent_id"])
            if parent is not None:
                parent["children"].append(s)
            else:
                roots.append(s)
        return roots


def _span_dict(s) -> dict:
    return {
        "name": s.name, "span_id": s.span_id,
        "parent_id": s.parent_id,
        "seconds": round(s.seconds, 6), "attrs": dict(s.attrs),
    }


def subtree(spans, root_span_id: int) -> list:
    """The spans descending from ``root_span_id`` (root excluded)."""
    children: dict = {}
    for s in spans:
        children.setdefault(s.parent_id, []).append(s)
    out, stack = [], [root_span_id]
    while stack:
        for s in children.get(stack.pop(), ()):
            out.append(s)
            stack.append(s.span_id)
    return out


def build_profile(spans, sql: str = "", kind: str = "",
                  query_class: str = "", seconds: float | None = None,
                  rows: int | None = None, seq: int = 0) -> QueryProfile:
    """Fold one trace's finished spans into a QueryProfile.

    ``spans`` is ``tracer.spans_for(trace_id)``; the root "query" span
    supplies totals when ``seconds``/``rows`` are not passed."""
    p = QueryProfile(sql=sql, kind=kind, query_class=query_class,
                     seq=seq)
    root = next((s for s in spans if s.parent_id is None), None)
    if root is not None:
        p.trace_id = root.trace_id
        p.kind = p.kind or str(root.attrs.get("kind", ""))
    elif spans:
        p.trace_id = spans[0].trace_id
    p.seconds = (seconds if seconds is not None
                 else (root.seconds if root is not None else 0.0))
    p.stages = {k: 0.0 for k in STAGE_KEYS}
    p.pruning = {k: 0 for k in PRUNING_KEYS}
    rows_out = 0
    for s in spans:
        a = s.attrs
        if a.get("plan_cache") and not p.plan_cache:
            p.plan_cache = str(a["plan_cache"])
        if "syncsan_compiles" in a and not p.syncsan:
            p.syncsan = {
                k[len("syncsan_"):]: int(v) for k, v in a.items()
                if k.startswith("syncsan_")}
        if "memsan_peak" in a and not p.memsan:
            p.memsan = {
                k[len("memsan_"):]: int(v) for k, v in a.items()
                if k.startswith("memsan_")}
        if s.name == "ssa.compile":
            p.compile_seconds += s.seconds
        if s.name == "plan.fuse":
            # whole-plan single-trace execution (ssa.plan_fuse): one
            # span per fused dispatch carrying the fusion accounting
            p.fused_stages = max(p.fused_stages,
                                 int(a.get("fused_stages", 0)))
            p.fragments_elided += int(a.get("fragments_elided", 0))
            if a.get("compile_cache") == "miss":
                p.compile_cache = "miss"
            elif (a.get("compile_cache") == "hit"
                  and not p.compile_cache):
                p.compile_cache = "hit"
            p.compile_seconds += float(
                a.get("first_trace_seconds", 0.0))
            continue
        if s.name == "dispatch.batch":
            # cross-query micro-batch seat (kqp/batch.py): one span per
            # member on its own session thread, so per-statement
            # profiles attribute window wait vs shared execute
            p.batch_id = int(a.get("batch_id", 0))
            p.batch_size = int(a.get("batch_size", 0))
            p.shared_scan = int(a.get("shared_scan", 0))
            p.batch_wait_seconds += float(a.get("wait_seconds", 0.0))
            p.batch_execute_seconds += float(
                a.get("execute_seconds", 0.0))
            continue
        if s.name == "dq.task":
            # DQ queries run their device dispatches inside compute
            # actors (no scan/transform spans on that path): the tasks'
            # accumulated compute seconds ARE the device time
            p.stages["compute"] += float(a.get("compute_seconds", 0.0))
            continue
        if s.name not in SCAN_SPANS and s.name != "transform":
            continue
        if a.get("compile_cache") == "miss":
            p.compile_cache = "miss"
        elif a.get("compile_cache") == "hit" and not p.compile_cache:
            p.compile_cache = "hit"
        p.compile_seconds += float(a.get("first_trace_seconds", 0.0))
        if s.name in SCAN_SPANS:
            rows_out += int(a.get("rows", 0))
            for k in STAGE_KEYS:
                p.stages[k] += float(a.get(f"stage_{k}", 0.0))
            for k in PRUNING_KEYS:
                p.pruning[k] += int(a.get(k, 0))
    p.stages = {k: round(v, 6) for k, v in p.stages.items()}
    p.rows = rows if rows is not None else rows_out
    p.execute_seconds = max(0.0, p.seconds - p.compile_seconds)
    p.device_seconds = p.stages.get("compute", 0.0)
    p.host_seconds = round(sum(
        v for k, v in p.stages.items() if k != "compute"), 6)
    p.spans = [_span_dict(s) for s in spans]
    return p


def classify_plan(plan) -> str:
    """Query class for latency-histogram bucketing: joins dominate
    aggregates dominate plain scans."""
    from ydb_tpu_torch.plan.nodes import Concat, ExpandJoin, LookupJoin, \
        Transform
    from ydb_tpu_torch.ssa.program import GroupByStep

    has_join = False
    has_agg = False
    stack = [plan]
    while stack:
        n = stack.pop()
        if isinstance(n, (LookupJoin, ExpandJoin)):
            has_join = True
            stack += [n.probe, n.build]
        elif isinstance(n, Transform):
            if any(isinstance(st, GroupByStep)
                   for st in n.program.steps):
                has_agg = True
            stack.append(n.input)
        elif isinstance(n, Concat):
            stack += list(n.inputs)
        else:
            prog = getattr(n, "program", None)
            if prog is not None and any(
                    isinstance(st, GroupByStep) for st in prog.steps):
                has_agg = True
    if has_join:
        return "select_join"
    if has_agg:
        return "select_agg"
    return "select_scan"


class ProfileRing:
    """Bounded ring of recent QueryProfiles (the ``.sys/top_queries``
    backing store). Thread-safe: concurrent sessions append while sys
    views / the viewer snapshot."""

    def __init__(self, capacity: int = 128):
        self.capacity = max(1, int(capacity))
        self._items: list[QueryProfile] = []
        self._lock = threading.Lock()
        self._seq = 0

    def add(self, profile: QueryProfile) -> None:
        with self._lock:
            self._seq += 1
            profile.seq = self._seq
            self._items.append(profile)
            if len(self._items) > self.capacity:
                del self._items[: len(self._items) - self.capacity]

    def recent(self) -> list[QueryProfile]:
        """Arrival order, oldest first."""
        with self._lock:
            return list(self._items)

    def top(self, n: int = 16) -> list[QueryProfile]:
        """The n most expensive retained queries, slowest first."""
        with self._lock:
            items = list(self._items)
        items.sort(key=lambda p: p.seconds, reverse=True)
        return items[:n]

    def __len__(self) -> int:
        with self._lock:
            return len(self._items)


def format_plan_analyzed(plan, profile: QueryProfile) -> str:
    """EXPLAIN ANALYZE rendering: the physical plan plus measured
    actuals (per-stage seconds, pruning/row counts, compile-vs-execute
    split). Key=value lines so tests and tools parse them directly."""
    from ydb_tpu_torch.plan.nodes import format_plan

    lines = [format_plan(plan), "-- actuals --"]
    lines.append(
        f"total: seconds={profile.seconds:.6f} rows={profile.rows}")
    lines.append(
        "compile: compile_cache=" + (profile.compile_cache or "none")
        + f" compile_seconds={profile.compile_seconds:.6f}"
        + f" execute_seconds={profile.execute_seconds:.6f}")
    if profile.syncsan:
        ss = profile.syncsan
        lines.append("syncsan: " + " ".join(
            f"{k}={ss.get(k, 0)}"
            for k in ("h2d", "d2h", "syncs", "debug_syncs", "captures",
                      "builds", "compiles")))
    if profile.memsan:
        ms = profile.memsan
        lines.append("memsan: " + " ".join(
            f"{k}={ms.get(k, 0)}"
            for k in ("peak", "live", "charges", "unbudgeted")))
    if profile.fused_stages:
        lines.append(
            f"fusion: fused_stages={profile.fused_stages}"
            f" fragments_elided={profile.fragments_elided}")
    if profile.batch_size:
        lines.append(
            f"batching: batch_id={profile.batch_id}"
            f" batch_size={profile.batch_size}"
            f" shared_scan={profile.shared_scan}"
            f" wait_seconds={profile.batch_wait_seconds:.6f}"
            f" execute_seconds={profile.batch_execute_seconds:.6f}")
    st = profile.stages
    lines.append("stages: " + " ".join(
        f"{k}={st.get(k, 0.0):.6f}" for k in STAGE_KEYS))
    pr = profile.pruning
    lines.append("rows: " + " ".join(
        f"{k}={pr.get(k, 0)}" for k in PRUNING_KEYS))
    occ = profile.stage_occupancy
    if occ:
        frac = occ.get("fraction", {})
        bits = [f"{k}={frac.get(k, 0.0):.4f}" for k in STAGE_KEYS
                if k in frac]
        for pair, coeff in sorted(occ.get("overlap", {}).items()):
            bits.append(f"{pair}={coeff:.4f}")
        lines.append("occupancy: " + " ".join(bits))
    for s in profile.spans:
        if s["name"] not in SCAN_SPANS:
            continue
        a = s["attrs"]
        bits = [f"seconds={s['seconds']:.6f}"]
        for k in ("table", "shard", "rows", "compile_cache"):
            if k in a:
                bits.append(f"{k}={a[k]}")
        lines.append(f"  {s['name']}: " + " ".join(bits))
    return "\n".join(lines)


class _Holder:
    profile: QueryProfile | None = None


@contextlib.contextmanager
def profiled(sql: str = "", kind: str = "select",
             query_class: str = "", tracer=None):
    """Run a block under a fresh root span and hand back its profile
    (``holder.profile`` after exit) — the bench.py seam for profiling
    engine-tier scans that never pass through a session."""
    from ydb_tpu_torch.obs.tracing import Tracer, activate

    tr = tracer if tracer is not None else Tracer()
    holder = _Holder()
    root = tr.trace("query")
    t0 = time.perf_counter()
    try:
        with activate(root):
            yield holder
    finally:
        root.finish()
        holder.profile = build_profile(
            tr.spans_for(root.trace_id), sql=sql, kind=kind,
            query_class=query_class,
            seconds=time.perf_counter() - t0)
