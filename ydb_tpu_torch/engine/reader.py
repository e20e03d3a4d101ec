"""Portion-granular streaming scan pipeline with PK merge + MVCC dedup.

The port's own copy of ``ydb_tpu/engine/reader.py``. What changes is the
device side: blocks are built on the scan's side CUDA stream through
pinned slabs (``engine/staging.py``, one ``Stager`` per stream) and
handed to the consumer with an event (``staging.accept``); every source
takes the ``device`` its blocks go to (the shard's device when None).
The tracing, timeline and chaos hooks come with ROADMAP.md queue A
item 7.

The out-of-core read path of the ColumnShard — the analog of the
reference's scan fetching script + K-way PK merge
(engines/reader/plain_reader/iterator/fetching.h:12, scanner.h:69,
merge.cpp:10 NArrow::NMerger):

  * portions are planned into **clusters** by PK-range overlap; within a
    cluster rows merge by PK with newest-wins dedup (portions ordered
    oldest -> newest by commit snapshot; the native ``ydbtpu_kway_merge``
    or its numpy twin does the batch merging —
    ydb_tpu/native/src/ydbtpu_native.cpp);
  * the merge is **incremental**: each portion blob is chunk-indexed
    (engine/portion.py) and a per-run cursor keeps only a couple of
    chunks buffered, so host memory is bounded by
    O(runs x chunk_rows) even when every portion overlaps every other
    (uniform-random upserts) — the interval-bounded merge of the
    reference's TScanHead (plain_reader/iterator/scanner.h:69), not a
    cluster materialization;
  * the next payload is prefetched on a worker thread while the current
    one streams to the device (the conveyor-offload pattern,
    tx/conveyor/service/service.h:73);
  * output blocks all share one fixed capacity, so a single compiled
    program serves the whole stream.
"""

from __future__ import annotations

import contextlib
import os
import queue
import threading
from typing import Iterator

import numpy as np

from ydb_tpu_torch import native
from ydb_tpu_torch.blocks.block import TableBlock
from ydb_tpu_torch.chaos import deadline as statement_deadline
from ydb_tpu_torch.device import resolve_device
from ydb_tpu_torch.engine import staging
from ydb_tpu_torch.engine.portion import (
    PortionChunkReader,
    PortionMeta,
    project_chunk,
    read_portion_blob,
)


def _chunk_in_range(meta: dict, pk_range) -> bool:
    """Chunk-level PK pruning off the blob header bounds."""
    if pk_range is None:
        return True
    lo, hi = pk_range
    cmin, cmax = meta.get("pk_min"), meta.get("pk_max")
    if lo is not None and cmax is not None and cmax < lo:
        return False
    if hi is not None and cmin is not None and cmin > hi:
        return False
    return True


def _chunk_selected(meta: dict, pk_range, preds) -> bool:
    """General chunk pruning: PK range plus conjunctive filter
    predicates against the chunk's v1-header zone maps (the PK check is
    just the oldest special case of the zone path). Conservative: a
    chunk without zones (v0 header) is always read."""
    if not _chunk_in_range(meta, pk_range):
        return False
    if preds:
        from ydb_tpu_torch.stats.zonemap import zones_decide

        skip, _all = zones_decide(meta.get("zones") if meta else None,
                                  preds)
        if skip:
            return False
    return True


def rechunk(payloads, names, cap: int):
    """Re-cut a stream of (cols, valid) payloads into exactly-``cap``-row
    pieces (last piece partial). Shared by the block stream and
    compaction output cutting.

    Low-copy: a payload whose boundary already aligns with ``cap``
    passes its arrays through untouched (the common case once portion
    chunk sizes divide the block size), and a single buffered piece
    flushes as its own slice views — ``np.concatenate`` only runs when
    a block genuinely straddles payloads."""
    buf: list[tuple[dict, dict]] = []
    buf_n = 0

    def flush():
        if len(buf) == 1:
            return buf[0]
        return ({m: np.concatenate([b[0][m] for b in buf]) for m in names},
                {m: np.concatenate([b[1][m] for b in buf]) for m in names})

    for cols, valid in payloads:
        n = len(next(iter(cols.values()))) if cols else 0
        if not buf_n and n == cap:
            # aligned payload: no buffering, no copy — pass through
            yield ({m: cols[m] for m in names},
                   {m: valid[m] for m in names})
            continue
        off = 0
        while off < n:
            take = min(cap - buf_n, n - off)
            if take == n:
                # whole payload in one piece: keep the original arrays
                # (a [0:n] slice would demote them to views, costing the
                # device-transfer aliasing fast path downstream)
                buf.append(({m: cols[m] for m in names},
                            {m: valid[m] for m in names}))
            else:
                buf.append((
                    {m: cols[m][off:off + take] for m in names},
                    {m: valid[m][off:off + take] for m in names},
                ))
            buf_n += take
            off += take
            if buf_n == cap:
                yield flush()
                buf, buf_n = [], 0
    if buf_n:
        yield flush()


def plan_clusters(
    metas: list[PortionMeta], dedup: bool
) -> list[list[PortionMeta]]:
    """Group portions into PK-overlap clusters (granule planning analog).

    Without dedup every portion streams independently. With dedup,
    portions whose [pk_min, pk_max] ranges overlap must merge together;
    portions with no PK stats (empty or statless) conservatively join
    one cluster with everything they might overlap.
    """
    if not dedup:
        return [[m] for m in metas]
    statless = [m for m in metas if m.pk_min is None]
    ranged = sorted(
        (m for m in metas if m.pk_min is not None),
        key=lambda m: (m.pk_min, m.pk_max, m.portion_id),
    )
    clusters: list[list[PortionMeta]] = []
    cur: list[PortionMeta] = []
    cur_max: int | None = None
    for m in ranged:
        if cur and m.pk_min > cur_max:
            clusters.append(cur)
            cur, cur_max = [], None
        cur.append(m)
        cur_max = m.pk_max if cur_max is None else max(cur_max, m.pk_max)
    if cur:
        clusters.append(cur)
    if statless:
        # merge everything into one cluster: no stats, no pruning
        flat = statless + [m for c in clusters for m in c]
        return [sorted(flat, key=lambda m: m.portion_id)]
    return clusters


class _RunCursor:
    """Chunk-granular cursor over one PK-sorted portion (a merge run).

    Buffers whole chunks; ``pop`` releases merged rows from the front.
    Schema-evolution nulls match ColumnShard._materialize: a column only
    reads from portions at least as new as the version that added it.
    """

    def __init__(self, source: "PortionStreamSource", meta: PortionMeta,
                 names: tuple[str, ...]):
        self.source = source
        self.meta = meta
        self.names = names
        self.reader = PortionChunkReader(source.shard.store, meta.blob_id)
        self.next_chunk = 0
        self.cols = {n: [] for n in names}   # buffered chunk slices
        self.valid = {n: [] for n in names}
        self.pk_buf = np.empty(0, dtype=np.int64)

    @property
    def done(self) -> bool:
        return self.next_chunk >= self.reader.n_chunks

    @property
    def size(self) -> int:
        return len(self.pk_buf)

    @property
    def last_pk(self) -> int:
        return int(self.pk_buf[-1])

    def _read_chunk(self, i: int) -> tuple[dict, dict]:
        t = self.source.timer
        ctx = (t.stage("read") if t is not None
               else contextlib.nullcontext())
        with ctx:
            c, v = self.reader.read_chunk(i)
            self.source.chunks_read += 1
            shard = self.source.shard
            return project_chunk(shard.schema, shard.column_added,
                                 self.meta, self.names, c, v)

    def fill_more(self) -> None:
        """Append the next chunk to the buffer (PK-pruned chunks skip).

        Only the PK range prunes here: this cursor feeds the K-way
        newest-wins merge, where value-predicate skips could resurrect
        shadowed row versions (see PortionStreamSource.preds)."""
        i = self.next_chunk
        self.next_chunk += 1
        if not _chunk_in_range(self.reader.chunk_meta(i),
                               self.source.pk_range):
            self.source.chunks_skipped += 1
            return
        cols, valid = self._read_chunk(i)
        for n in self.names:
            self.cols[n].append(cols[n])
            self.valid[n].append(valid[n])
        pk = self.source.shard.pk_column
        self.pk_buf = np.concatenate([
            self.pk_buf,
            np.ascontiguousarray(cols[pk], dtype=np.int64),
        ])

    def fill(self) -> None:
        """Ensure the buffer is non-empty (or the run is exhausted)."""
        while self.size == 0 and not self.done:
            self.fill_more()

    def take(self, bound: int | None) -> int:
        """Rows at the buffer front with pk <= bound (all when None)."""
        if bound is None:
            return self.size
        return int(np.searchsorted(self.pk_buf, bound, side="right"))

    def slices(self, k: int) -> tuple[dict, dict]:
        cat_c = {n: (np.concatenate(a) if len(a) != 1 else a[0])
                 for n, a in self.cols.items()}
        cat_v = {n: (np.concatenate(a) if len(a) != 1 else a[0])
                 for n, a in self.valid.items()}
        self.cols = {n: [cat_c[n]] for n in self.names}
        self.valid = {n: [cat_v[n]] for n in self.names}
        return ({n: cat_c[n][:k] for n in self.names},
                {n: cat_v[n][:k] for n in self.names})

    def pop(self, k: int) -> None:
        self.cols = {n: [self.cols[n][0][k:]] for n in self.names}
        self.valid = {n: [self.valid[n][0][k:]] for n in self.names}
        self.pk_buf = self.pk_buf[k:]


class PortionStreamSource:
    """ColumnSource-compatible streaming reader over shard portions.

    Duck-types the ``ColumnSource`` surface that ``ScanExecutor`` uses:
    ``schema``, ``dicts``, ``num_rows`` (pre-dedup upper bound) and
    ``blocks()``.
    """

    def __init__(
        self,
        shard,
        metas: list[PortionMeta],
        columns: tuple[str, ...] | None = None,
        dedup: bool | None = None,
        prefetch: bool = True,
        pk_range: tuple[int | None, int | None] | None = None,
        timer=None,
        preds=None,
        device=None,
    ):
        self.shard = shard
        self.metas = list(metas)
        #: where blocks go unless ``blocks`` names another device
        self.device = (device if device is not None
                       else getattr(shard, "device", None))
        # chunk-granular PK pruning window (coarse: callers still filter)
        self.pk_range = pk_range
        # conjunctive filter predicates (stats.zonemap.Pred) for
        # chunk-granular zone pruning. Only the NON-merging read path
        # consults them: inside a K-way dedup merge a skipped newer
        # chunk could resurrect the older row version it shadows, so
        # merged clusters read every in-PK-range chunk. Single-portion
        # clusters are always safe — portions hold unique PKs.
        self.preds = list(preds or [])
        self.chunks_read = 0  # observability: chunk fetches actually done
        self.chunks_skipped = 0  # chunks zone/PK-pruned without a fetch
        self.portions_skipped = 0  # whole portions pruned by zone maps
        # per-scan stage accounting (obs.probes.StageTimer): blob reads
        # charge "read", K-way merging "merge"; None = untimed
        self.timer = timer
        names = columns if columns is not None else shard.schema.names
        self.columns_read = tuple(names)
        self.schema = shard.schema.select(self.columns_read)
        self.dicts = shard.dicts
        self.dedup = (
            dedup if dedup is not None
            else bool(shard.upsert and shard.pk_column)
        )
        self.prefetch = prefetch
        # HBM-resident tier attribution: portions/rows served from
        # decoded device arrays instead of the staged host path
        # (engine.resident; sys_resident_store + shard.scan spans)
        self.resident_hits = 0
        self.resident_rows = 0
        # morsel-pipeline attribution (engine.stream_sched): the live
        # scheduler while a pipelined stream runs, kept after it ends
        # for the stat snapshot (shard.scan spans / bench extras)
        self._pipeline = None
        self._finished_pipeline = None

    # ---- morsel-pipeline hooks (engine.stream_sched owner surface) ----

    def attach_pipeline(self, sched) -> None:
        self._pipeline = sched

    def finish_pipeline(self, sched) -> None:
        self._pipeline = None
        self._finished_pipeline = sched

    @property
    def last_pipeline(self) -> "dict | None":
        """Stat snapshot of the last pipelined stream, taken lazily —
        the producer finishes the pipeline while the consumer is still
        draining queued blocks, so an eager snapshot would undercount
        ``blocks_consumed``."""
        s = self._finished_pipeline
        return None if s is None else s.snapshot()

    def note_block_consumed(self) -> None:
        """In-order consumption credit from the executor (run_stream):
        forwarded to the scheduler's slab accounting (live or finished
        — the tail blocks outlive the producer); a no-op on the
        serialized path."""
        p = self._pipeline or self._finished_pipeline
        if p is not None:
            p.note_consumed()

    @property
    def num_rows(self) -> int:
        """Upper bound (pre-dedup): callers size block capacity with it."""
        return sum(m.num_rows for m in self.metas)

    # ---- cluster loading (host side, bounded) ----

    def _read_portion(self, meta: PortionMeta, names) -> tuple[dict, dict]:
        """One portion's columns + validity with schema-evolution nulls
        (same semantics as ColumnShard._materialize)."""
        c, v = read_portion_blob(self.shard.store, meta.blob_id)
        return project_chunk(self.shard.schema, self.shard.column_added,
                             meta, names, c, v)

    def _iter_merged(self, cluster: list[PortionMeta], names):
        """Incremental K-way newest-wins merge over a PK-overlap cluster.

        Yields bounded (cols, valid) payloads in global PK order. At each
        step the *bound* is the smallest last-buffered PK over unfinished
        runs: every row with pk <= bound is provably buffered (runs are
        PK-sorted, and runs still at the bound are extended first), so a
        batch merge of the <=bound prefixes is final — the incremental
        analog of the reference's interval merge (scanner.h:69).
        """
        pk = self.shard.pk_column
        read_names = tuple(names)
        if pk not in read_names:
            read_names = read_names + (pk,)
        ordered = sorted(cluster, key=lambda m: (m.commit_snap,
                                                 m.portion_id))
        cursors = [_RunCursor(self, m, read_names) for m in ordered]
        while True:
            for c in cursors:
                c.fill()
            if not any(c.size for c in cursors):
                return
            not_done = [c for c in cursors if not c.done]
            bound = (min(c.last_pk for c in not_done)
                     if not_done else None)
            if bound is not None:
                # duplicates of the bound key may straddle a chunk edge:
                # extend runs until their buffers pass the bound
                for c in cursors:
                    while not c.done and c.last_pk <= bound:
                        c.fill_more()
            mctx = (self.timer.stage("merge") if self.timer is not None
                    else contextlib.nullcontext())
            with mctx:
                takes = [c.take(bound) for c in cursors]
                parts = []
                runs = []
                for c, k in zip(cursors, takes):
                    if k == 0:
                        continue
                    parts.append(c.slices(k))
                    runs.append(c.pk_buf[:k])
                run_idx, row_idx = native.kway_merge(runs, dedup=True)
                # gather per-run instead of concatenate-then-gather:
                # with dedup the merged output is SMALLER than the
                # buffered input, so materializing a concatenated copy
                # of every run just to index it wastes the difference;
                # per-run fancy gathers write each output row exactly
                # once
                out_n = len(run_idx)
                sels = [np.flatnonzero(run_idx == r)
                        for r in range(len(parts))]
                rsels = [row_idx[s] for s in sels]
                cols = {}
                valid = {}
                for n in names:
                    first = parts[0][0][n]
                    oc = np.empty(out_n, dtype=first.dtype)
                    ov = np.empty(out_n, dtype=np.bool_)
                    for p, s, rs in zip(parts, sels, rsels):
                        oc[s] = p[0][n][rs]
                        ov[s] = p[1][n][rs]
                    cols[n] = oc
                    valid[n] = ov
                for c, k in zip(cursors, takes):
                    if k:
                        c.pop(k)
            yield cols, valid

    def _iter_plain(self, cluster: list[PortionMeta], names):
        """No-merge streaming: portion chunks emit in portion order.
        Chunk-granular pruning (PK range + zone-map predicates) happens
        here — skipped chunks are never fetched from the store."""
        for m in cluster:
            rd = PortionChunkReader(self.shard.store, m.blob_id)
            for i in range(rd.n_chunks):
                if not _chunk_selected(rd.chunk_meta(i), self.pk_range,
                                       self.preds):
                    self.chunks_skipped += 1
                    continue
                rctx = (self.timer.stage("read")
                        if self.timer is not None
                        else contextlib.nullcontext())
                with rctx:
                    c, v = rd.read_chunk(i)
                    self.chunks_read += 1
                    out = project_chunk(self.shard.schema,
                                        self.shard.column_added,
                                        m, names, c, v)
                yield out

    def payload_stream(self, clusters, names):
        """All clusters as a stream of bounded (cols, valid) payloads."""
        pk = self.shard.pk_column
        for cl in clusters:
            if self.dedup and pk is not None and len(cl) > 1:
                yield from self._iter_merged(cl, names)
            else:
                yield from self._iter_plain(cl, names)

    def _load_cluster(self, cluster: list[PortionMeta], names):
        """Materialize ONE cluster (compaction of bounded jobs; tests).
        The scan path streams via payload_stream instead."""
        pk = self.shard.pk_column
        if self.dedup and pk is not None and len(cluster) > 1:
            payloads = list(self._iter_merged(cluster, names))
        else:
            payloads = list(self._iter_plain(cluster, names))
        if not payloads:
            empty_c = {n: np.empty(
                0, dtype=self.shard.schema.field(n).type.physical)
                for n in names}
            return empty_c, {n: np.empty(0, dtype=bool) for n in names}
        cols = {n: np.concatenate([p[0][n] for p in payloads])
                for n in names}
        valid = {n: np.concatenate([p[1][n] for p in payloads])
                 for n in names}
        return cols, valid

    # ---- block stream ----

    def blocks(
        self,
        block_rows: int,
        columns: tuple[str, ...] | None = None,
        start_block: int = 0,
        device=None,
    ) -> Iterator[TableBlock]:
        """The stream's blocks on ``device`` (the source's device when
        None; CUDA when that is None too)."""
        dev = resolve_device(device if device is not None else self.device)
        names = columns if columns is not None else self.columns_read
        sch = self.shard.schema.select(names)
        cap = min(block_rows, max(self.num_rows, 1))
        clusters = plan_clusters(self.metas, self.dedup)
        if start_block == 0:
            from ydb_tpu_torch.engine import stream_sched

            if stream_sched.pipeline_enabled():
                # morsel-driven pipeline: out-of-order IO/decode on the
                # stream conveyor, in-order assembly, double-buffered
                # slabs — resident-tier placement folded in. Count-based
                # resume (start_block) keeps the serialized path: its
                # block arithmetic must not depend on pipeline state.
                yield from stream_sched.stream_pipeline(
                    [(self, clusters)], names, sch, cap,
                    timer=self.timer, prefetch=self.prefetch,
                    owner=self, device=dev)
                return
        if start_block == 0 and _resident_on(self, dev):
            # device-resident fast path: portions with pinned decoded
            # columns assemble blocks device-side; the rest stage
            # through the host path mid-stream. Count-based resume
            # (start_block) stays on the host path — its block
            # boundaries must not depend on what happens to be
            # resident at resume time.
            from ydb_tpu_torch.engine import resident as resident_mod

            yield from resident_mod.stream_resident(
                self, clusters, names, sch, cap,
                timer=self.timer, prefetch=self.prefetch, device=dev)
            return
        yield from stream_blocks(
            self.payload_stream(clusters, names), names, sch, cap,
            start_block=start_block, prefetch=self.prefetch,
            timer=self.timer, device=dev,
        )

    # NOTE deliberately no n_blocks(): with dedup the emitted block count
    # is only known after merging, so any count-based resume arithmetic
    # (DQ checkpoint seek) must count actual emissions, not estimate.


def _resident_on(source, dev) -> bool:
    """Whether ``source``'s shard serves resident columns to blocks on
    ``dev`` (its store is on and holds tensors on that device)."""
    from ydb_tpu_torch.device import same_device

    res = getattr(source.shard, "resident", None)
    return (res is not None and res.enabled()
            and same_device(res.device, dev))


#: test/bench override for the staging lookahead: an int forces the
#: depth, None reads the (cached) environment — the FUSE_FORCE pattern
PREFETCH_DEPTH_FORCE: "int | None" = None

#: cached YDB_TPU_TORCH_PREFETCH_DEPTH: the env var is configuration, not a
#: per-stream knob, and re-reading the environment on every stream put
#: a getenv on the hot scan path. None = not read yet.
_prefetch_depth_env: "int | None" = None
_prefetch_depth_lock = threading.Lock()


def _prefetch_depth() -> int:
    """Staging lookahead (device blocks buffered ahead of the consumer).
    Depth 2 keeps one block in transfer while one waits, without pinning
    unbounded host/device memory. Read from the environment ONCE;
    ``PREFETCH_DEPTH_FORCE`` is the in-process override seam."""
    global _prefetch_depth_env
    if PREFETCH_DEPTH_FORCE is not None:
        return PREFETCH_DEPTH_FORCE
    depth = _prefetch_depth_env
    if depth is None:
        with _prefetch_depth_lock:
            if _prefetch_depth_env is None:
                try:
                    _prefetch_depth_env = int(
                        os.environ.get("YDB_TPU_TORCH_PREFETCH_DEPTH", "2"))
                except ValueError:
                    _prefetch_depth_env = 2
            depth = _prefetch_depth_env
    return depth


def stream_blocks(payloads, names, sch, cap: int,
                  start_block: int = 0,
                  prefetch: bool = True,
                  depth: int | None = None,
                  timer=None, device=None) -> Iterator[TableBlock]:
    """(cols, valid) payload stream -> fixed-capacity TableBlocks.

    The staging pipeline: a producer task on the SHARED conveyor pool
    (runtime.conveyor.shared_conveyor — no per-scan executor churn)
    drains the payload stream, re-cuts it (``rechunk``), builds device
    blocks on ``device`` (a ``staging.Stager`` issues the host->device
    transfer on the scan's side stream), and parks them in a
    ``depth``-bounded queue. Blob IO, host merge AND
    the next blocks' device transfers all overlap the consumer's device
    compute; ``depth`` bounds how far the producer runs ahead.

    ``timer`` (obs.probes.StageTimer) charges block building to the
    "stage" stage. Always emits at least one (possibly empty) block:
    consumers size their compiled programs off the stream. Abandoning
    the generator (close/GC) stops the producer promptly — the bounded
    put is stop-aware, so no task leaks on the shared pool.
    """
    stager = staging.Stager(device)

    def build(cols, valid):
        ctx = (timer.stage("stage") if timer is not None
               else contextlib.nullcontext())
        with ctx:
            return stager.from_numpy(cols, valid, sch, cap)

    pieces = rechunk(payloads, names, cap)

    def gen():
        emitted = 0
        for cols, valid in pieces:
            # per-piece cancellation: the conveyor carried the
            # statement deadline onto the producer thread, so an
            # expired statement stops staging (the error relays to the
            # consumer and the worker slot frees)
            statement_deadline.check_current("stage")
            emitted += 1
            if emitted - 1 < start_block:
                continue  # checkpoint-resume seek: skips BEFORE staging
            yield build(cols, valid)
        if emitted == 0 and start_block == 0:
            yield build(
                {m: np.empty(0, dtype=sch.field(m).type.physical)
                 for m in names},
                {m: np.empty(0, dtype=bool) for m in names})

    return pump_blocks(gen(), prefetch=prefetch, depth=depth)


def pump_blocks(blocks, prefetch: bool = True,
                depth: int | None = None) -> Iterator[TableBlock]:
    """Drain a block generator on the SHARED conveyor pool ahead of the
    consumer (the staging producer shape shared by the host payload
    path and the resident tier's mixed stream). With no idle worker —
    or prefetch off — the generator runs inline on the consumer. Each
    block reaches the consumer through ``staging.accept`` on the
    consumer's thread."""
    depth = _prefetch_depth() if depth is None else depth
    if not prefetch or depth <= 0:
        for blk in blocks:
            yield staging.accept(blk)
        return

    from ydb_tpu_torch.runtime.conveyor import shared_conveyor

    q: queue.Queue = queue.Queue(maxsize=max(1, depth))
    stop = threading.Event()

    def put(item) -> bool:
        """Stop-aware bounded put: an abandoned consumer sets ``stop``
        and the producer exits instead of parking forever."""
        while not stop.is_set():
            try:
                q.put(item, timeout=0.05)
                return True
            except queue.Full:
                continue
        return False

    def produce():
        emitted = 0
        try:
            for blk in blocks:
                if stop.is_set():
                    return
                emitted += 1
                if not put(("blk", blk)):
                    return
            put(("end", emitted))
        except BaseException as e:  # noqa: BLE001 - relayed to consumer
            put(("err", e))
        finally:
            # abandoned consumer (stop set): a bare return here would
            # strand the generator's finally blocks — the morsel
            # scheduler's teardown (stream_sched.close) lives there, so
            # close it on THIS thread, the one iterating it
            close = getattr(blocks, "close", None)
            if close is not None:
                close()

    # atomic free-worker admission: a producer must never QUEUE behind
    # other parked producers (its consumer would starve waiting on a
    # task that cannot start) — with no idle worker, stage inline
    handle = shared_conveyor().submit_if_free("scan_prefetch", produce)
    if handle is None:
        for blk in blocks:
            yield staging.accept(blk)
        return
    try:
        while True:
            # consumer-side cancellation: raising here runs the finally
            # below — stop is set, the queue drains, the producer exits
            # and its conveyor slot frees (no leaked tasks)
            statement_deadline.check_current("scan")
            try:
                kind, payload = q.get(timeout=0.05)
            except queue.Empty:
                if handle.done.is_set() and q.empty():
                    # producer finished without a terminal message:
                    # cancelled during pool shutdown — surface that
                    handle.wait(0)
                    raise RuntimeError("block staging producer vanished")
                continue
            if kind == "blk":
                yield staging.accept(payload)
            elif kind == "end":
                return
            else:
                raise payload
    finally:
        stop.set()
        with contextlib.suppress(queue.Empty):
            while True:
                q.get_nowait()


class MultiShardStreamSource:
    """Streaming ColumnSource over every shard of a sharded table at one
    snapshot — the SQL path's scan source. Per-shard portion streams
    (PK-merged + deduped under upsert) concatenate into one
    fixed-capacity block stream; nothing materializes beyond the merge
    working set, so SELECTs inherit the same out-of-core bound as direct
    shard scans (the KQP scan fan-out shape, kqp_scan_executer.cpp)."""

    def __init__(self, shards, schema, dicts, snap=None,
                 columns: tuple[str, ...] | None = None,
                 timer=None, device=None):
        names = columns if columns is not None else schema.names
        self.columns_read = tuple(names)
        self._base_schema = schema
        self.schema = schema.select(self.columns_read)
        self.dicts = dicts
        self.timer = timer
        self._shards = list(shards)
        self._snap = snap
        #: where blocks go unless ``blocks`` names another device (the
        #: first shard's device when None)
        self.device = (device if device is not None else
                       getattr(self._shards[0], "device", None)
                       if self._shards else None)
        self.preds: tuple = ()
        self._pipeline = None
        self._finished_pipeline = None
        self.subs = [
            PortionStreamSource(s, s.visible_portions(snap),
                                columns=self.columns_read, timer=timer,
                                device=self.device)
            for s in shards
        ]

    def attach_timer(self, timer) -> "MultiShardStreamSource":
        """Late-bind a StageTimer (the SQL scan path creates the source
        at snapshot time, before any program — and with it any profile
        span — exists)."""
        self.timer = timer
        for sub in self.subs:
            sub.timer = timer
        return self

    # ---- morsel-pipeline hooks (engine.stream_sched owner surface) ----

    def attach_pipeline(self, sched) -> None:
        self._pipeline = sched

    def finish_pipeline(self, sched) -> None:
        self._pipeline = None
        self._finished_pipeline = sched

    @property
    def last_pipeline(self) -> "dict | None":
        s = self._finished_pipeline
        return None if s is None else s.snapshot()

    def note_block_consumed(self) -> None:
        p = self._pipeline or self._finished_pipeline
        if p is not None:
            p.note_consumed()

    def with_predicates(self, preds) -> "MultiShardStreamSource":
        """A pruned VIEW of this source for one program's conjunctive
        filter predicates (stats.zonemap.Pred): portion-level zone
        pruning for shards whose rows never shadow (non-upsert), plus
        chunk-granular pruning inside every sub-stream. The base source
        stays untouched — other programs over the same snapshot keep
        their unpruned streams — and ``device_cache_key`` carries the
        predicate fingerprint so pruned block streams never collide
        with unpruned ones in the device cache."""
        from ydb_tpu_torch.stats.zonemap import preds_fingerprint, zones_decide

        view = MultiShardStreamSource(
            self._shards, self._base_schema, self.dicts, self._snap,
            columns=self.columns_read, timer=self.timer,
            device=self.device)
        view.preds = preds_fingerprint(preds)
        for sub in view.subs:
            sub.preds = list(preds)
            if not getattr(sub.shard, "upsert", False):
                kept = []
                res = getattr(sub.shard, "resident", None)
                for m in sub.metas:
                    skip, _all = zones_decide(m.zones, sub.preds)
                    if skip:
                        sub.portions_skipped += 1
                        if res is not None:
                            # zone-pruned portions have no resident
                            # value: feed the eviction policy
                            res.note_pruned(m.portion_id)
                    else:
                        kept.append(m)
                sub.metas = kept
        return view

    @property
    def num_rows(self) -> int:
        """Pre-dedup upper bound across all shards."""
        return sum(sub.num_rows for sub in self.subs)

    def device_cache_key(self, read_cols, block_rows: int):
        """Identity of this source's block stream for the device block
        cache: per-shard (shard id, visible portion ids) plus the block
        geometry AND the pruning-predicate fingerprint (a pruned stream
        holds fewer rows than an unpruned one over the same portions —
        serving one for the other would drop data). Portions are
        immutable, so equal keys produce equal streams; any
        commit/compaction changes some shard's portion set and with it
        the key."""
        return (
            tuple((sub.shard.shard_id,
                   tuple(m.portion_id for m in sub.metas))
                  for sub in self.subs),
            tuple(read_cols), block_rows, self.preds,
        )

    @property
    def chunks_read(self) -> int:
        return sum(sub.chunks_read for sub in self.subs)

    @property
    def chunks_skipped(self) -> int:
        return sum(sub.chunks_skipped for sub in self.subs)

    @property
    def portions_skipped(self) -> int:
        return sum(sub.portions_skipped for sub in self.subs)

    @property
    def resident_hits(self) -> int:
        return sum(sub.resident_hits for sub in self.subs)

    @property
    def resident_rows(self) -> int:
        return sum(sub.resident_rows for sub in self.subs)

    def blocks(
        self,
        block_rows: int,
        columns: tuple[str, ...] | None = None,
        start_block: int = 0,
        device=None,
    ) -> Iterator[TableBlock]:
        """The stream's blocks on ``device`` (the source's device when
        None)."""
        dev = resolve_device(device if device is not None else self.device)
        names = columns if columns is not None else self.columns_read
        sch = self._base_schema.select(names)
        cap = min(block_rows, max(self.num_rows, 1))
        if start_block == 0:
            from ydb_tpu_torch.engine import stream_sched

            if stream_sched.pipeline_enabled():
                # one scheduler spans ALL shards: IO morsels of shard
                # k+1 fly while shard k's blocks are consumed, under a
                # single byte budget and one block capacity (one
                # compiled program)
                yield from stream_sched.stream_pipeline(
                    [(sub, plan_clusters(sub.metas, sub.dedup))
                     for sub in self.subs],
                    names, sch, cap, timer=self.timer, owner=self,
                    device=dev)
                return
        if start_block == 0 and any(_resident_on(sub, dev)
                                    for sub in self.subs):
            # resident-aware SQL path: one mixed item stream across all
            # shards keeps a single block capacity (one compiled
            # program), while each shard's portions serve from its own
            # resident store or stage through the host path
            from ydb_tpu_torch.engine import resident as resident_mod

            def items():
                for sub in self.subs:
                    clusters = plan_clusters(sub.metas, sub.dedup)
                    yield from resident_mod.scan_items(sub, clusters,
                                                       names, dev)

            yield from pump_blocks(resident_mod.mixed_blocks(
                items(), names, sch, cap, timer=self.timer, device=dev))
            return

        def payloads():
            for sub in self.subs:
                clusters = plan_clusters(sub.metas, sub.dedup)
                yield from sub.payload_stream(clusters, names)

        yield from stream_blocks(payloads(), names, sch, cap,
                                 start_block=start_block,
                                 timer=self.timer, device=dev)
