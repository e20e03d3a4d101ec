"""Morsel-driven streaming pipeline for out-of-core scans.

The port of ``ydb_tpu/engine/stream_sched.py``. Its double-buffered
device slabs are pinned host slabs copied on the scan's side CUDA
stream and fenced with an event per block (``engine/staging.py``); the
rest is the reference's host scheduling, unchanged, with its leak
handle per morsel, its tracked lock and its ``resident_bytes`` counter
(``obs/timeline.py``).

The serialized OOC read path runs blob read -> decode -> stage ->
compute as one chain per portion: a single conveyor producer does all
the movement work while the consumer computes, so scan throughput is
the SUM of the stage times. Theseus's thesis (PAPERS.md) says it should
be the MAX: every data-movement stage overlapped, throughput bounded
only by the slowest one. This module is that architecture for the
ColumnShard scan:

  * surviving portion clusters decompose into fixed-byte-budget
    **morsels** (``YDB_TPU_TORCH_MORSEL_BYTES`` of decoded data each; chunk
    pruning happens at planning time so skipped chunks never become
    work);
  * IO morsels run **out of order** on a dedicated conveyor pool
    (``runtime.conveyor.stream_conveyor``) — blob fetch + decode +
    schema projection for morsels k+1..k+d proceed while morsel k is
    consumed — and are consumed **in order** by the assembly stage, so
    payload order (and with it every block boundary) is exactly the
    serialized path's;
  * the in-order item stream feeds ``resident.mixed_blocks`` and then
    ``reader.pump_blocks``: the depth-bounded block queue IS the
    double-buffered device slab — H2D transfer of block k+1 overlaps
    compute on block k;
  * placement is resident-tier-aware: HBM-resident portions yield
    device items (zero movement) while cold portions stream behind
    them, with the same heat/promotion bookkeeping as
    ``resident.scan_items``;
  * admission back-pressures on a byte budget (``YDB_TPU_TORCH_STREAM_BYTES``
    of estimated decoded bytes in flight), so peak host memory stays
    inside the OOC valve no matter how many portions survive pruning.

Deadlock freedom is by **work stealing**, not queue sizing: every
flight is a small state machine (PENDING/RUNNING/DONE/CANCELLED) and
the in-order consumer claims and runs the head morsel inline whenever
its worker task has not started — under a saturated or stalled pool the
pipeline degrades to exactly the serialized path instead of waiting on
a task that cannot run. K-way dedup merges stay inline in the assembly
stage (their cursors are inherently sequential); their chunk reads
still ride the retry policy.

Gates: ``YDB_TPU_TORCH_STREAM_PIPELINE=0`` is the escape hatch back to the
serialized path (the A/B bit-identity switch); ``PIPELINE_FORCE`` is
the in-process override for tests/bench, same contract as
``FUSE_FORCE``/``RESIDENT_FORCE``. Results are bit-identical either
way: the pipeline reuses the serialized path's chunk reader, payload
boundaries, ``rechunk`` re-cutting and block assembly, only the
threads change.
"""

from __future__ import annotations

import collections
import contextlib
import os
import threading

from ydb_tpu_torch.analysis import leaksan, sanitizer
from ydb_tpu_torch.chaos import deadline as statement_deadline
from ydb_tpu_torch.obs import timeline
from ydb_tpu_torch.engine.portion import (_TRANSIENT_READ,
                                          PortionChunkReader,
                                          project_chunk)

#: test/bench override: True/False forces the gate, None = environment
PIPELINE_FORCE: "bool | None" = None


def pipeline_enabled() -> bool:
    """Morsel-pipeline gate, default ON (YDB_TPU_TORCH_STREAM_PIPELINE=0 is
    the serialized-path escape hatch for A/B and emergencies)."""
    if PIPELINE_FORCE is not None:
        return PIPELINE_FORCE
    return os.environ.get("YDB_TPU_TORCH_STREAM_PIPELINE", "1") \
        not in ("0", "", "off")


def morsel_bytes() -> int:
    """Decoded-byte budget of ONE morsel: big enough that per-task
    overhead vanishes, small enough that a portion splits into units
    the pool can spread."""
    try:
        return max(1 << 16,
                   int(os.environ.get("YDB_TPU_TORCH_MORSEL_BYTES",
                                      str(16 << 20))))
    except ValueError:
        return 16 << 20


def stream_budget() -> int:
    """Estimated decoded bytes allowed in flight (admitted but not yet
    consumed) — the back-pressure valve that keeps pipeline RSS
    bounded regardless of portion count."""
    try:
        return max(1 << 20,
                   int(os.environ.get("YDB_TPU_TORCH_STREAM_BYTES",
                                      str(128 << 20))))
    except ValueError:
        return 128 << 20


# ---------------- morsel planning ----------------


class _DevMorsel:
    """An HBM-resident portion: ready instantly, zero movement."""

    __slots__ = ("entries", "rows")

    def __init__(self, entries, rows):
        self.entries = entries
        self.rows = rows


class _MergeMorsel:
    """A K-way dedup cluster: executed inline in the assembly stage
    (the merge cursors are sequential by nature)."""

    __slots__ = ("source", "cluster")

    def __init__(self, source, cluster):
        self.source = source
        self.cluster = cluster


class _IoMorsel:
    """A run of surviving chunks of one cold portion: blob fetch +
    decode + projection, executable on any worker (or stolen)."""

    __slots__ = ("source", "meta", "reader", "chunks", "est_bytes")

    def __init__(self, source, meta, reader, chunks, est_bytes):
        self.source = source
        self.meta = meta
        self.reader = reader
        self.chunks = chunks
        self.est_bytes = est_bytes


def _open_reader(store, blob_id) -> PortionChunkReader:
    """Header read with one extra outer attempt on top of the reader's
    own RetryPolicy. Planning draws fault injections concurrently with
    worker IO, so a transient burst the serialized path would meet
    spread across many calls can land wholly on one header read; a
    second fresh retry budget absorbs any burst shorter than twice the
    policy's attempts."""
    try:
        return PortionChunkReader(store, blob_id)
    except _TRANSIENT_READ:
        return PortionChunkReader(store, blob_id)


def _row_width(schema, names) -> int:
    """Estimated decoded bytes per row of the read columns (payload +
    validity byte)."""
    return sum(schema.field(n).type.physical.itemsize + 1
               for n in names) or 1


def plan_morsels(parts, names, device=None):
    """Lazily decompose ``[(source, clusters)]`` into morsels, in
    exactly the serialized path's consumption order.

    Pulled incrementally by the scheduler's admission loop, so header
    reads and resident lookups happen only as far ahead as the byte
    budget allows. Chunk pruning (PK range + zone predicates) and the
    resident-tier heat/promotion bookkeeping happen here, identical to
    ``_iter_plain`` / ``resident.scan_items`` — pruned chunks never
    become flights. Resident columns serve only blocks bound for their
    store's device (``device``; None = any)."""
    from ydb_tpu_torch.device import same_device
    from ydb_tpu_torch.engine import resident as resident_mod
    from ydb_tpu_torch.engine.reader import _chunk_selected

    cap = morsel_bytes()
    for source, clusters in parts:
        shard = source.shard
        store = getattr(shard, "resident", None)
        on = (store is not None and store.enabled()
              and (device is None or same_device(store.device, device)))
        pk = shard.pk_column
        width = _row_width(shard.schema.select(names), names)
        for cl in clusters:
            if source.dedup and pk is not None and len(cl) > 1:
                yield _MergeMorsel(source, cl)
                continue
            for m in cl:
                if on:
                    ent = store.lookup(m.portion_id, names)
                    if ent is not None:
                        source.resident_hits += 1
                        source.resident_rows += m.num_rows
                        timeline.add_bytes("resident_bytes", sum(
                            e.nbytes for e in ent.values()))
                        yield _DevMorsel(ent, m.num_rows)
                        continue
                    if store.record_miss(m.portion_id):
                        store.promote_async(
                            m.portion_id, m.num_rows,
                            resident_mod.portion_loader(shard, m))
                rd = _open_reader(shard.store, m.blob_id)
                sel: list[int] = []
                est = 0
                for i in range(rd.n_chunks):
                    cm = rd.chunk_meta(i)
                    if not _chunk_selected(cm, source.pk_range,
                                           source.preds):
                        source.chunks_skipped += 1
                        continue
                    rows = cm.get("rows") or m.num_rows or 1
                    sel.append(i)
                    # the zero-copy decode keeps the chunk's whole blob
                    # bytes alive (every column, not only the read ones),
                    # so those bytes count when they exceed the read
                    # columns' width (the reference counts the width
                    # only and overruns its valve on narrow reads)
                    est += max(rows * width, cm.get("len") or 0)
                    if est >= cap:
                        yield _IoMorsel(source, m, rd, tuple(sel), est)
                        sel, est = [], 0
                if sel:
                    yield _IoMorsel(source, m, rd, tuple(sel), est)


# ---------------- flights + scheduler ----------------

_PENDING, _RUNNING, _DONE, _FAILED, _CANCELLED = range(5)


class _FlightSlot:
    """One admitted IO morsel crossing threads. State transitions are
    guarded by the scheduler lock; ``event`` fires on any terminal
    worker outcome. The leaksan handle opens at admission and closes
    exactly once at retire (consume or cancel) — consumer-owned, so a
    worker never races the close."""

    __slots__ = ("morsel", "state", "payloads", "error", "event",
                 "leak", "retired", "idx")

    def __init__(self, morsel, leak, idx):
        self.morsel = morsel
        self.state = _PENDING
        self.payloads = None
        self.error = None
        self.event = threading.Event()
        self.leak = leak
        self.retired = False
        self.idx = idx


class StreamScheduler:
    """Admission + in-order consumption over the morsel plan.

    Thread model: the plan iterator and the in-order queue are touched
    ONLY by the assembly thread (the pump_blocks producer); the lock
    guards flight state, the in-flight byte ledger and the stat
    counters that workers and the block consumer also touch."""

    def __init__(self, parts, names, timer=None, device=None):
        self.names = tuple(names)
        self.timer = timer
        self._plan = plan_morsels(parts, self.names, device)
        self._plan_done = False
        self._queue: collections.deque = collections.deque()
        self._lock = sanitizer.make_lock(
            f"stream_sched.{id(self):x}.lock")
        self._budget = stream_budget()
        self._inflight_bytes = 0
        self._inflight_io = 0
        self._next_idx = 0
        self._closed = False
        # stats surfaced on the scan span / bench extras
        self.stats = {
            "morsels_io": 0, "morsels_dev": 0, "morsels_merge": 0,
            "stolen": 0, "ready_out_of_order": 0, "reruns": 0,
            "peak_inflight_bytes": 0, "est_bytes": 0,
            "blocks_emitted": 0, "blocks_consumed": 0,
            "peak_live_blocks": 0,
        }

    # ---- admission (assembly thread only) ----

    def _admit(self) -> None:
        """Pull the plan and launch IO flights while the byte budget
        holds. The head of an empty pipeline always admits (one morsel
        larger than the whole budget must still run), and planning runs
        PAST non-IO morsels so cold portions behind a resident run or a
        merge already stream while those are consumed."""
        while not self._plan_done:
            with self._lock:
                if self._closed:
                    return  # torn down mid-admission: launch nothing
                full = (self._inflight_io > 0
                        and self._inflight_bytes >= self._budget)
            if full:
                return
            m = next(self._plan, None)
            if m is None:
                self._plan_done = True
                return
            if isinstance(m, _DevMorsel):
                with self._lock:
                    self.stats["morsels_dev"] += 1
                self._queue.append(m)
            elif isinstance(m, _MergeMorsel):
                with self._lock:
                    self.stats["morsels_merge"] += 1
                self._queue.append(m)
            else:
                self._queue.append(self._launch(m))

    def _launch(self, m: _IoMorsel) -> _FlightSlot:
        from ydb_tpu_torch.runtime.conveyor import stream_conveyor

        fl = _FlightSlot(m, leaksan.track("stream.morsel", m.meta.blob_id),
                         self._next_idx)
        self._next_idx += 1
        with self._lock:
            self._inflight_bytes += m.est_bytes
            self._inflight_io += 1
            self.stats["morsels_io"] += 1
            self.stats["est_bytes"] += m.est_bytes
            # fixed key set (initialized in __init__), counters only —
            # bounded by construction  # ydb-lint: disable=R007
            self.stats["peak_inflight_bytes"] = max(
                self.stats["peak_inflight_bytes"], self._inflight_bytes)
        try:
            stream_conveyor().submit("stream_morsel", self._run_flight,
                                     fl)
        except RuntimeError:
            # pool shut down (tests teardown): the consumer steals it
            pass
        return fl

    # ---- execution (worker threads or stolen inline) ----

    def _run_flight(self, fl: _FlightSlot, claimed: bool = False) -> None:
        if not claimed:
            with self._lock:
                if fl.state != _PENDING:
                    return  # stolen by the consumer, or cancelled
                fl.state = _RUNNING
        try:
            payloads = self._execute_io(fl)
        except BaseException as e:  # noqa: BLE001 - relayed via slot
            with self._lock:
                if fl.state == _RUNNING:
                    fl.state = _FAILED
                    fl.error = e
        else:
            with self._lock:
                if fl.state == _RUNNING:
                    fl.state = _DONE
                    fl.payloads = payloads
        finally:
            fl.event.set()

    def _execute_io(self, fl: _FlightSlot) -> list:
        """Fetch + decode + project every chunk of one morsel (same
        retry policy, chunk order and projection as ``_iter_plain``;
        one payload per chunk so payload boundaries match exactly)."""
        m = fl.morsel
        shard = m.source.shard
        out = []
        for i in m.chunks:
            with self._lock:
                cancelled = fl.state == _CANCELLED
            if cancelled:
                break
            statement_deadline.check_current("read")
            ctx = (self.timer.stage("read", morsel=fl.idx)
                   if self.timer is not None
                   else contextlib.nullcontext())
            with ctx:
                c, v = m.reader.read_chunk(i, zero_copy=True)
                out.append(project_chunk(shard.schema,
                                         shard.column_added,
                                         m.meta, self.names, c, v))
        return out

    # ---- in-order consumption (assembly thread only) ----

    def _collect(self, fl: _FlightSlot) -> list:
        """Block until the head flight is done, stealing it inline if
        its worker task has not started — guaranteed progress under any
        pool state. Retires the flight (budget credit) on every
        path."""
        try:
            with self._lock:
                steal = fl.state == _PENDING
                if steal:
                    fl.state = _RUNNING
                    self.stats["stolen"] += 1
                elif fl.state != _DONE and any(
                        isinstance(q, _FlightSlot)
                        and q.state in (_DONE, _FAILED)
                        for q in self._queue):
                    # a later morsel finished before this head: the
                    # out-of-order readiness the in-order queue absorbs
                    self.stats["ready_out_of_order"] += 1
            if steal:
                self._run_flight(fl, claimed=True)
            else:
                while not fl.event.wait(0.05):
                    # consumer-side cancellation while a worker runs
                    statement_deadline.check_current("read")
            with self._lock:
                state, err, payloads = fl.state, fl.error, fl.payloads
            if state == _FAILED and isinstance(err, _TRANSIENT_READ):
                # the worker's RetryPolicy drowned in a fault burst
                # (concurrent flights split the injection/outage window
                # across retry budgets): re-run the morsel inline ONCE
                # with a fresh budget before surrendering the scan
                with self._lock:
                    fl.state = _RUNNING
                    fl.error = None
                    self.stats["reruns"] += 1
                self._run_flight(fl, claimed=True)
                with self._lock:
                    state, err, payloads = \
                        fl.state, fl.error, fl.payloads
            if state == _FAILED:
                raise err
            if state != _DONE:
                raise RuntimeError("morsel flight cancelled mid-scan")
            fl.morsel.source.chunks_read += len(fl.morsel.chunks)
            return payloads
        finally:
            self._retire(fl)

    def _retire(self, fl: _FlightSlot) -> None:
        """Idempotent terminal accounting: exactly one budget credit
        and one leak close per flight, no matter which of consume /
        cancel / close gets there first."""
        with self._lock:
            if fl.retired:
                return
            fl.retired = True
            self._inflight_bytes -= fl.morsel.est_bytes
            self._inflight_io -= 1
            lk, fl.leak = fl.leak, None
        leaksan.close(lk)

    def items(self):
        """The in-order ('dev'/'host') item stream for
        ``resident.mixed_blocks`` — identical item order and payload
        boundaries to ``resident.scan_items`` over the same clusters
        (and, with no resident store, to ``payload_stream``)."""
        try:
            while True:
                self._admit()
                if not self._queue:
                    return
                m = self._queue.popleft()
                if isinstance(m, _FlightSlot):
                    payloads = self._collect(m)
                    # refill the window BEFORE yielding: downstream
                    # staging/compute runs while fresh flights fly
                    self._admit()
                    for cols, valid in payloads:
                        yield ("host", cols, valid)
                elif isinstance(m, _DevMorsel):
                    yield ("dev", m.entries, m.rows)
                else:
                    # inline K-way merge: its blob reads/merge charge
                    # the usual stages; cold portions AFTER it (already
                    # admitted above) stream meanwhile
                    for cols, valid in m.source._iter_merged(
                            m.cluster, self.names):
                        yield ("host", cols, valid)
        finally:
            self.close()

    # ---- cancellation / teardown ----

    def close(self) -> None:
        """Cancel every admitted flight and retire it: pending tasks
        become no-ops, running workers notice and stop between chunks,
        and every flight retires — a mid-scan deadline or an abandoned
        stream drains to zero. Re-entrant, not just
        idempotent: a flight admitted concurrently with an earlier
        close (the consumer-abandon race) is swept by the next call —
        every exit path calls close, so the last one wins."""
        with self._lock:
            self._closed = True
            flights = [q for q in self._queue
                       if isinstance(q, _FlightSlot)]
            for fl in flights:
                if fl.state in (_PENDING, _RUNNING):
                    fl.state = _CANCELLED
        self._queue.clear()
        for fl in flights:
            self._retire(fl)

    # ---- consumption credit (any thread) ----

    def note_emitted(self) -> None:
        with self._lock:
            self.stats["blocks_emitted"] += 1
            self.stats["peak_live_blocks"] = max(
                self.stats["peak_live_blocks"],
                self.stats["blocks_emitted"]
                - self.stats["blocks_consumed"])

    def note_consumed(self) -> None:
        """In-order consumption credit from the executor
        (scan.run_stream): tracks how many emitted blocks are still
        live on the device side — the measured double-buffer depth."""
        with self._lock:
            self.stats["blocks_consumed"] += 1

    def snapshot(self) -> dict:
        with self._lock:
            return dict(self.stats)


def stream_pipeline(parts, names, sch, cap, timer=None, prefetch=True,
                    owner=None, device=None):
    """Morsel-pipelined block stream over ``[(source, clusters)]``.

    The assembly generator (mixed_blocks over the scheduler's in-order
    items) runs on the shared conveyor via ``pump_blocks`` — its
    depth-bounded queue is the double-buffered device slab stage — and
    the scheduler's dedicated pool runs the IO morsels underneath it.
    ``owner`` (the stream source) gets ``attach_pipeline(sched)`` while
    the stream runs (so the executor's in-order consumption credit
    reaches ``note_consumed``) and ``finish_pipeline(sched)`` when it
    ends or is abandoned (the stat snapshot for the scan span). Blocks
    go to ``device``."""
    from ydb_tpu_torch.engine import resident as resident_mod
    from ydb_tpu_torch.engine.reader import pump_blocks

    sched = StreamScheduler(parts, names, timer=timer, device=device)
    if owner is not None:
        owner.attach_pipeline(sched)

    def gen():
        try:
            for blk in resident_mod.mixed_blocks(
                    sched.items(), sched.names, sch, cap, timer=timer,
                    device=device):
                sched.note_emitted()
                yield blk
        finally:
            sched.close()
            if owner is not None:
                owner.finish_pipeline(sched)
    return pump_blocks(gen(), prefetch=prefetch)
