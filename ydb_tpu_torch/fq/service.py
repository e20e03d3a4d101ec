"""Federated/streaming query service: continuous SQL over topics.

Mirror of the reference's FQ platform (ydb/core/fq/libs: control
plane storing query definitions, row dispatcher reading shared topic
partitions, checkpoint coordinator persisting operator state —
checkpoint_coordinator.h:25, checkpoint_storage/; SURVEY.md §2.13 row
"FQ / streaming platform"), built on this framework's own planes:

  * source/sink are PersQueue topics; rows travel as JSON objects;
  * each poll() processes one micro-batch through the REAL SQL path
    (parse -> plan -> device execution on a batch ColumnSource) and
    folds the batch aggregates into durable running state — the
    incremental shape of the reference's task graph with a
    WideCombiner state, expressed as batch-fold;
  * exactly-once effects: the tablet checkpoint (source offset, agg
    state, emit seqno) commits AFTER the sink write, and sink writes
    carry producer seqnos — a crash between sink write and checkpoint
    replays the batch, and the PQ producer-dedup drops the duplicate
    emission (topic/pq.py _WriteTx seqno guard). The checkpointing
    contract of dq/checkpoint.py at the service level.

Query shape supported: SELECT <keys and aggregates> FROM stream
[WHERE ...] [GROUP BY ...] with count/sum/min/max (aggregates must be
fold-combinable; avg rewrites to sum+count pairs at the edge are the
caller's concern, matching the two-phase-agg restriction).

The port's own copy of ``ydb_tpu/fq/service.py``: the same state tablet
(``fq/<name>``, its tables and rows), batch semantics, folds, windows and
sink records. Each micro-batch is a ``ColumnSource`` staged on the
query's ``device`` (CUDA by default; the CPU only when asked) and runs
through the port's ``plan_select_full`` -> ``execute_plan`` -> ``to_host``
under the port's default routing, so a batch of at most ``FUSE_MAX_ROWS``
rows is one fused dispatch (a new ``Database`` each batch: a new CUDA
graph capture each batch, as the reference traces each batch anew), and
a ``GROUP BY`` over more than ``ONEHOT_GROUP_LIMIT`` groups reaches the
CUDA group-by kernels. ``execute_plan`` and ``to_host`` hold
``device.work_lock`` as every statement does. ``StreamingQuery.stats``
counts polls, batches, rows and the batches' fused captures and replays
(a port addition).
"""

from __future__ import annotations

import json

import numpy as np
import torch

from ydb_tpu_torch import dtypes
from ydb_tpu_torch.blocks.dictionary import DictionarySet
from ydb_tpu_torch.device import resolve_device
from ydb_tpu_torch.engine.blobs import BlobStore
from ydb_tpu_torch.engine.scan import ColumnSource
from ydb_tpu_torch.plan import Database, execute_plan, to_host
from ydb_tpu_torch.sql import ast
from ydb_tpu_torch.sql.parser import parse
from ydb_tpu_torch.sql.planner import Catalog, plan_select_full
from ydb_tpu_torch.tablet.executor import TabletExecutor

_FOLD = {
    "count": lambda a, b: a + b,
    "sum": lambda a, b: a + b,
    "min": min,
    "max": max,
}


class StreamingQuery:
    """One continuous query: source topic -> SQL -> sink topic."""

    def __init__(self, name: str, sql: str, schema: dtypes.Schema,
                 source, sink, store: BlobStore,
                 batch_limit: int = 1024,
                 window: tuple | None = None,
                 device: "str | torch.device | None" = None):
        """``window``: optional (event_time_field, size_us,
        lateness_us) — tumbling event-time windows with watermark
        semantics (the compute-actor watermark plane,
        dq_compute_actor_impl.h): the watermark is max event time seen
        minus the allowed lateness; a window finalizes — its groups
        emit ONCE with window bounds and its state drops — when the
        watermark passes its end; events older than a finalized window
        are dropped late arrivals (counted, not applied). ``device``
        is where each micro-batch runs (CUDA unless the caller names the
        CPU)."""
        self.name = name
        self.sql = sql
        self.schema = schema
        self.source = source          # Topic
        self.sink = sink              # Topic | None
        self.batch_limit = batch_limit
        self.window = window
        self.device = resolve_device(device)
        #: polls that consumed rows, micro-batch runs (one a window a
        #: poll), rows run, and the batches' fused captures and replays
        self.stats = {"polls": 0, "batches": 0, "rows": 0,
                      "captures": 0, "replays": 0}
        self.executor = TabletExecutor.boot(f"fq/{name}", store)
        stmt = parse(sql)
        if not isinstance(stmt, ast.Select):
            raise ValueError("streaming query must be a SELECT")
        self._select = stmt
        self._key_cols, self._agg_cols = self._classify(stmt)

    @staticmethod
    def _classify(stmt: ast.Select):
        from ydb_tpu_torch.sql.planner import _AGG_FUNCS

        keys, aggs = [], []
        for item in stmt.items:
            name = item.alias or getattr(item.expr, "column", None)
            if isinstance(item.expr, ast.FuncCall) and (
                    item.expr.name in _AGG_FUNCS or item.expr.star):
                kind = "count" if item.expr.star else item.expr.name
                if kind not in _FOLD:
                    raise ValueError(
                        f"aggregate {kind} is not fold-combinable; "
                        "rewrite (e.g. avg -> sum + count) upstream")
                aggs.append((name, kind))
            else:
                keys.append(name)
        return keys, aggs

    # -- durable state --

    def _state(self) -> tuple[dict, dict, int, dict]:
        db = self.executor.db
        meta = db.table("meta").get(("cursor",)) or {
            "offsets": {}, "emit_seqno": 0, "late_dropped": 0}
        state = {}
        for (key_json,), row in db.table("state").range():
            state[key_json] = row["aggs"]
        return meta["offsets"], state, meta["emit_seqno"], meta

    # -- one micro-batch --

    def poll(self) -> int:
        """Process available source messages; returns rows consumed.
        Emits (changed groups, or watermark-finalized windows) to the
        sink, then checkpoints atomically."""
        offsets, state, emit_seqno, meta = self._state()
        rows, new_offsets = [], dict(offsets)
        for pi, part in enumerate(self.source.partitions):
            start = offsets.get(str(pi), 0)
            msgs = part.read(start, limit=self.batch_limit)
            for m in msgs:
                try:
                    rows.append(json.loads(m["data"]))
                except json.JSONDecodeError:
                    continue  # poison messages are skipped, not fatal
            if msgs:
                new_offsets[str(pi)] = msgs[-1]["offset"] + 1
        if not rows:
            return 0
        self.stats["polls"] += 1

        if self.window is None:
            changed = self._fold(state, self._run_batch(rows))
            payloads = []
            for key_json in sorted(changed):
                rec = dict(zip(self._key_cols, json.loads(key_json)))
                rec.update(state[key_json])
                payloads.append(rec)
            finalized: list = []
            new_meta = {"offsets": new_offsets}
        else:
            payloads, changed, finalized, new_meta = \
                self._poll_windowed(rows, state, meta)
            new_meta["offsets"] = new_offsets

        # 1. emit (idempotent via producer seqno) ...
        if self.sink is not None and payloads:
            self.sink.partitions[0].write(
                [{"data": json.dumps(p)} for p in payloads],
                producer=f"fq/{self.name}",
                first_seqno=emit_seqno + 1)
            emit_seqno += len(payloads)

        # 2. ... THEN checkpoint; a crash in between replays the batch
        # and the seqno guard swallows the duplicate emission
        new_meta["emit_seqno"] = emit_seqno

        finalized_set = set(finalized)

        def fn(txc):
            txc.put("meta", ("cursor",), new_meta)
            for key_json in changed:
                if key_json not in finalized_set:
                    txc.put("state", (key_json,),
                            {"aggs": state[key_json]})
            for key_json in finalized:
                txc.erase("state", (key_json,))
        self.executor.run(fn)
        return len(rows)

    def _poll_windowed(self, rows, state, meta):
        """Tumbling-window batch: bucket rows by event-time window,
        fold per window, finalize windows the watermark passed."""
        ts_field, size, lateness = self.window
        finalized_before = meta.get("finalized_before")
        max_ts = meta.get("max_ts")
        late = meta.get("late_dropped", 0)
        buckets: dict[int, list] = {}
        for r in rows:
            ts = r.get(ts_field)
            if not isinstance(ts, (int, float)):
                continue  # unstamped rows are poison for windowing
            ts = int(ts)
            w = (ts // size) * size
            # late = the row's WINDOW is already finalized; rows below
            # the watermark whose window is still open must fold in
            if finalized_before is not None \
                    and w + size <= finalized_before:
                late += 1
                continue
            buckets.setdefault(w, []).append(r)
            max_ts = ts if max_ts is None else max(max_ts, ts)
        changed: set = set()
        for w, rs in sorted(buckets.items()):
            changed |= self._fold(state, self._run_batch(rs),
                                  window=w)
        # watermark = max event time - lateness; windows fully below
        # it finalize: emit once with bounds, drop their state
        payloads, finalized = [], []
        cut = None if max_ts is None else max_ts - lateness
        if cut is not None:
            # numeric event-time order, not JSON-string order
            for key_json in sorted(state,
                                   key=lambda k: json.loads(k)):
                w, keyvals = json.loads(key_json)
                if w + size <= cut:
                    rec = {"window_start": w, "window_end": w + size}
                    rec.update(zip(self._key_cols, keyvals))
                    rec.update(state[key_json])
                    payloads.append(rec)
                    finalized.append(key_json)
        new_meta = {
            "max_ts": max_ts,
            "finalized_before": (max(cut, finalized_before)
                                 if finalized_before is not None
                                 else cut),
            "late_dropped": late,
        }
        return payloads, changed, finalized, new_meta

    def _run_batch(self, rows: list[dict]) -> list[dict]:
        """Run the SQL over one batch through the normal query path."""
        dicts = DictionarySet()
        arrays: dict[str, np.ndarray] = {}
        validity: dict[str, np.ndarray] = {}
        for f in self.schema.fields:
            vals = [r.get(f.name) for r in rows]
            ok = np.array([v is not None for v in vals], dtype=bool)
            if f.type.is_string:
                d = dicts.for_column(f.name)
                arrays[f.name] = np.array(
                    [d.add(v or "") for v in vals], dtype=np.int32)
            else:
                arrays[f.name] = np.array(
                    [v if v is not None else 0 for v in vals],
                    dtype=f.type.physical)
            validity[f.name] = ok
        src = ColumnSource(arrays, self.schema, dicts,
                           validity=validity)
        catalog = Catalog(schemas={"stream": self.schema},
                          primary_keys={}, dicts=dicts)
        pq = plan_select_full(parse(self.sql), catalog)
        db = Database(sources={"stream": src}, dicts=dicts,
                      device=self.device)
        out = to_host(execute_plan(pq.plan, db))
        self.stats["batches"] += 1
        self.stats["rows"] += len(rows)
        for key, fused in db._compile_cache.items():
            if isinstance(key, tuple) and key and key[0] == "plan_fuse":
                self.stats["captures"] += fused.captures
                self.stats["replays"] += fused.replays
        result = []
        n = out.num_rows
        cols = {}
        for f in out.schema.fields:
            v, _ok = out.cols[f.name]
            if f.type.is_string:
                src_d = pq.dict_aliases.get(f.name, f.name)
                cols[f.name] = [x.decode("utf-8", "surrogateescape")
                                for x in dicts[src_d].decode(
                                    np.asarray(v))]
            elif f.type.is_decimal:
                cols[f.name] = [int(x) for x in np.asarray(v)]
            else:
                cols[f.name] = [x.item() for x in np.asarray(v)]
        for i in range(n):
            result.append({k: cols[k][i] for k in cols})
        return result

    def _fold(self, state: dict, batch_out: list[dict],
              window: int | None = None) -> set:
        """Merge batch aggregates into running state; returns the set
        of changed group keys (JSON-encoded; windowed keys carry
        [window_start, [key values...]])."""
        changed = set()
        for row in batch_out:
            keyvals = [row[k] for k in self._key_cols]
            key_json = json.dumps(
                keyvals if window is None else [window, keyvals],
                sort_keys=True)
            cur = state.get(key_json)
            if cur is None:
                state[key_json] = {name: row[name]
                                   for name, _kind in self._agg_cols}
            else:
                for name, kind in self._agg_cols:
                    cur[name] = _FOLD[kind](cur[name], row[name])
            changed.add(key_json)
        return changed

    def results(self) -> list[dict]:
        """Current materialized view: running groups (non-windowed) or
        the still-open windows (windowed)."""
        _offsets, state, _seq, _meta = self._state()
        out = []
        for key_json, aggs in sorted(
                state.items(), key=lambda kv: json.loads(kv[0])):
            decoded = json.loads(key_json)
            if self.window is not None:
                w, keyvals = decoded
                rec = {"window_start": w,
                       "window_end": w + self.window[1]}
                rec.update(zip(self._key_cols, keyvals))
            else:
                rec = dict(zip(self._key_cols, decoded))
            rec.update(aggs)
            out.append(rec)
        return out

    def watermark_info(self) -> dict:
        _offsets, _state, _seq, meta = self._state()
        return {"max_ts": meta.get("max_ts"),
                "finalized_before": meta.get("finalized_before"),
                "late_dropped": meta.get("late_dropped", 0)}


class FederatedQueryService:
    """Control plane: named streaming queries over cluster topics
    (the fq control-plane/row-dispatcher analog, scoped to this
    framework's in-process cluster)."""

    def __init__(self, store: BlobStore,
                 device: "str | torch.device | None" = None):
        self.store = store
        self.device = resolve_device(device)
        self.queries: dict[str, StreamingQuery] = {}

    def create_query(self, name: str, sql: str, schema: dtypes.Schema,
                     source, sink=None, batch_limit: int = 1024,
                     window: tuple | None = None) -> StreamingQuery:
        if name in self.queries:
            raise ValueError(f"query {name} exists")
        q = StreamingQuery(name, sql, schema, source, sink,
                           self.store, batch_limit, window=window,
                           device=self.device)
        self.queries[name] = q
        return q

    def delete_query(self, name: str) -> None:
        self.queries.pop(name, None)

    def poll_all(self) -> dict[str, int]:
        return {name: q.poll() for name, q in self.queries.items()}
