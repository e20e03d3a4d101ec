"""HBM-resident column tier: decoded portion columns pinned on device.

The port of ``ydb_tpu/engine/resident.py``: entries are torch tensors
on the shard's device, copied there on a promotion stream and published
only once the copy is done; blocks are assembled on a scan's side stream
with ``narrow``/``torch.cat`` (``engine/staging.py``) and reuse the
resident tensors as-is in the aligned case. The auto budget is on when
the shard's device is CUDA (the reference asks
``jax.default_backend()``). The ``resident.lookup`` chaos site serves a
fault as a miss (the scan degrades mid-stream to the staged host path);
promotions and evictions fire the ``resident.promote`` /
``resident.evict`` probes; blocks served from the tier and blocks staged
beside them add to the timeline's ``resident_bytes`` / ``staged_bytes``.
The mesh device slices come with the mesh executor, ROADMAP.md queue A
item 13b.

The third level of the storage hierarchy (blob store -> host blocks ->
device-resident columns) and the engine-side answer to ROADMAP item 1:
the kernel tier runs Q1 at billions of rows/s because its blocks ALREADY
live in device memory, while the engine path re-ingests from host bytes
on every scan. Theseus's thesis (PAPERS.md) is that accelerator query
efficiency comes from *not moving data*, and TQP shows a device-resident
table representation is what makes whole-query tensor execution pay off
— this module is that representation for the ColumnShard.

Unlike ``DeviceBlockCache`` (whole block STREAMS keyed by portion set +
read columns + geometry + predicate fingerprint — any new column subset
or predicate rebuilds from host bytes), the resident store pins
per-(portion, column) decoded device arrays. Portions are immutable, so
one promoted portion serves EVERY scan shape: scans assemble
fixed-capacity ``TableBlock``s directly from resident arrays
(device-side slice + pad, zero host decode or transfer), and portions
not yet resident fall through to the staged host path mid-stream — a
partially resident table still wins on its resident fraction.

Promotion is asynchronous on the shared conveyor ("resident_promote"
queue): eager at portion write/compaction output (the columns are
already in memory) and heat-driven from scan access counters (a portion
read twice from the host path is worth pinning). Eviction is
budget-bounded (``YDB_TPU_TORCH_RESIDENT_BYTES`` valve, same semantics as the
scan-cache valve) with zone-map-informed victim choice: portions the
zone maps keep pruning away deliver no resident value and go first,
then cold-by-access portions (LRU heat). Invalidation is by immutable
portion id: compaction/TTL rewrites mint NEW ids, old ids keep serving
readers at old snapshots until GC drops them from the portion map.

Gates: ``YDB_TPU_TORCH_RESIDENT=0`` disables the tier everywhere (scans take
exactly the pre-tier path — the A/B bit-identity switch); ``=1`` forces
it on even on CPU backends (where the default budget is 0 because
"device" memory is host RSS). ``RESIDENT_FORCE`` is the in-process
override for tests/bench A/B without environment mutation.
"""

from __future__ import annotations

import contextlib
import os

import numpy as np
import torch

from ydb_tpu_torch import chaos
from ydb_tpu_torch.analysis import leaksan, memsan, sanitizer
from ydb_tpu_torch.blocks.block import Column, TableBlock, block_nbytes
from ydb_tpu_torch.chaos import deadline as statement_deadline
from ydb_tpu_torch import device as device_mod
from ydb_tpu_torch.device import capture_lock
from ydb_tpu_torch.engine import staging
from ydb_tpu_torch.obs import timeline
from ydb_tpu_torch.obs.probes import probe

_P_PROMOTE = probe("resident.promote")
_P_EVICT = probe("resident.evict")

#: test/bench override: True/False forces the gate, None = environment
RESIDENT_FORCE: "bool | None" = None

AUTO_BYTES = 4 << 30

#: host-path reads of one portion before heat promotion triggers
PROMOTE_HEAT = 2

#: concurrent promotion tasks per store: promotions ride the SHARED
#: conveyor next to scan-prefetch producers, so a flood of queued
#: promotions must never starve staging admission (submit_if_free turns
#: producers away whenever the heap is non-empty)
MAX_INFLIGHT = 4


def _gate() -> "bool | None":
    """Tri-state tier gate: False = off, True = forced on, None = auto
    (budget decides — on for accelerator backends, off on CPU)."""
    if RESIDENT_FORCE is not None:
        return RESIDENT_FORCE
    env = os.environ.get("YDB_TPU_TORCH_RESIDENT")
    if env is None:
        return None
    return env not in ("0", "", "off")


def default_budget(device=None) -> int:
    """Auto budget mirrors the scan cache: on when the store's device is
    CUDA, off for the CPU (there "device" memory is host RSS and the
    out-of-core tests own that bound)."""
    dev = torch.device(device_mod.DEFAULT_DEVICE if device is None
                          else device)
    return (AUTO_BYTES
            if dev.type == "cuda" and torch.cuda.is_available() else 0)


class _Entry:
    """One resident column of one portion: decoded device tensors at
    portion length (un-padded; scans slice/pad to block capacity)."""

    __slots__ = ("data", "validity", "nbytes")

    def __init__(self, data, validity):
        self.data = data
        self.validity = validity
        self.nbytes = int(data.nbytes) + int(validity.nbytes)


class ResidentStore:
    """Per-shard device-resident portion store.

    Thread model: one lock guards ALL mutable state (entry map, portion
    info, heat counters, in-flight set, byte ledger, stat counters).
    Device work (tensor construction) always happens OUTSIDE the lock;
    promotion single-flights per portion id via ``_inflight``.
    """

    def __init__(self, name: str, budget: "int | None" = None,
                 device=None):
        self.name = name
        self._budget = budget
        #: where promoted columns live (the shard's device)
        self.device = torch.device(
            device_mod.DEFAULT_DEVICE if device is None else device)
        # sanitizer-tracked under YDB_TPU_TORCH_TSAN=1; per-instance
        # names so distinct stores never share lockset state
        self._lock = sanitizer.make_lock(f"resident.{name}.lock")
        # (portion_id, column) -> _Entry
        self._cols = sanitizer.share({}, f"resident.{name}.cols")
        # portion_id -> {rows, nbytes, cols, heat, tick, zskips}
        self._info: dict = {}
        # portion_id -> host-path access count (heat toward promotion)
        self._miss_heat: dict = {}
        self._inflight: set = set()
        self._pending: list = []  # conveyor TaskHandles (drain support)
        self._stream = None  # promotion stream (CUDA), made lazily
        self._nbytes = 0
        self._tick = 0
        # counters (the sys_resident_store / viewer surface)
        self.hits = 0
        self.misses = 0
        self.promotions = 0
        self.evictions = 0
        self.spills = 0
        self.invalidations = 0
        self.errors = 0

    # ---- gates ----

    def budget(self) -> int:
        """YDB_TPU_TORCH_RESIDENT_BYTES overrides EVERYTHING (the
        operator's emergency valve for device-memory pressure; malformed
        values disable rather than poison the read path). Otherwise the
        constructor budget; else AUTO when the gate is forced on (so CPU
        tests get a real budget), else the device default."""
        env = os.environ.get("YDB_TPU_TORCH_RESIDENT_BYTES")
        if env is not None:
            try:
                return int(env)
            except ValueError:
                return 0
        if self._budget is not None:
            return self._budget
        if _gate() is True:
            return AUTO_BYTES
        return default_budget(self.device)

    def enabled(self) -> bool:
        g = _gate()
        if g is False:
            return False
        return self.budget() > 0

    # ---- read path ----

    def lookup(self, portion_id: int, names) -> "dict | None":
        """All-or-nothing: every requested column resident -> the entry
        dict (and a heat/LRU touch); any gap -> None (the scan falls
        through to the host path and ``record_miss`` counts the heat)."""
        if not names:
            return None
        if chaos.hit("resident.lookup", portion=portion_id) is not None:
            # injected device-memory fault: served as a miss, so the
            # scan degrades mid-stream to the staged host path
            chaos.note_fallback("resident.lookup")
            with self._lock:
                self.misses += 1
            return None
        with self._lock:
            self._tick += 1
            out = {}
            for n in names:
                e = self._cols.get((portion_id, n))
                if e is None:
                    self.misses += 1
                    return None
                out[n] = e
            info = self._info.get(portion_id)
            if info is not None:
                info["heat"] += 1
                info["tick"] = self._tick
            self.hits += 1
            return out

    def record_miss(self, portion_id: int) -> bool:
        """Host-path access bookkeeping. True when the portion just
        crossed the heat threshold and is worth promoting now."""
        with self._lock:
            self._tick += 1
            if len(self._miss_heat) > 4096 and \
                    portion_id not in self._miss_heat:
                # bound the heat map for ad-hoc workloads that scan a
                # long tail of portions exactly once
                self._miss_heat.clear()
            n = self._miss_heat.get(portion_id, 0) + 1
            self._miss_heat[portion_id] = n
            return n == PROMOTE_HEAT and portion_id not in self._inflight

    def note_pruned(self, portion_id: int) -> None:
        """A scan's zone maps pruned this portion entirely: its resident
        bytes served nothing. Eviction sends such portions first."""
        with self._lock:
            info = self._info.get(portion_id)
            if info is not None:
                info["zskips"] += 1

    # ---- promotion ----

    def _to_device(self, cols: dict, valid: dict) -> dict:
        """Host arrays -> _Entry per column on the store's device. On
        CUDA the copies run on the promotion stream, which is synchronized
        before the entries are returned: an entry is published only when
        its data is there, so readers on any stream need no fence for it.
        ``capture_lock`` is taken per column, so a scan's staging producer
        waits for one column's copy at most, not a whole portion's."""
        dev = self.device
        cuda = dev.type == "cuda"

        def put(a):
            a = np.ascontiguousarray(a)
            if not a.flags.writeable:
                a = a.copy()  # a zero-copy decoded view of blob bytes
            t = torch.from_numpy(a)
            if not cuda:
                return t.to(dev)
            with capture_lock:
                if self._stream is None:
                    self._stream = torch.cuda.Stream(dev)
                with torch.cuda.stream(self._stream):
                    return t.to(dev)

        out = {}
        for n, a in cols.items():
            v = valid.get(n)
            if v is None:
                v = np.ones(len(a), dtype=np.bool_)
            out[n] = _Entry(put(a), put(np.asarray(v, dtype=np.bool_)))
        if cuda:
            with capture_lock:
                self._stream.synchronize()
        return out

    def promote(self, portion_id: int, rows: int, cols: dict,
                valid: "dict | None") -> bool:
        """Synchronous promote: decode-free device copy of host arrays.
        Device tensor construction runs OUTSIDE the lock; insertion,
        accounting and budget eviction inside it."""
        if not self.enabled():
            return False
        budget = self.budget()
        with memsan.seam():
            entries = self._to_device(cols, valid or {})
        total = sum(e.nbytes for e in entries.values())
        if total > budget:
            # a single portion larger than the whole valve can never be
            # resident: spill — the host path keeps serving it
            with self._lock:
                self.spills += 1
            return False
        with self._lock:
            info = self._info.get(portion_id)
            if info is None:
                info = {"rows": rows, "nbytes": 0, "cols": set(),
                        "heat": self._miss_heat.pop(portion_id, 0),
                        "tick": self._tick, "zskips": 0}
                self._info[portion_id] = info
            added = 0
            for n, e in entries.items():
                if (portion_id, n) in self._cols:
                    continue  # concurrent promotion landed first
                self._cols[(portion_id, n)] = e
                info["cols"].add(n)
                info["nbytes"] += e.nbytes
                added += e.nbytes
            self._nbytes += added
            if added:
                self.promotions += 1
                if memsan.armed():
                    info.setdefault("tickets", []).append(
                        memsan.charge(added, "resident",
                                      owner=portion_id))
            evicted = self._evict_to_budget_locked(budget,
                                                   keep=portion_id)
        if _P_PROMOTE and added:
            _P_PROMOTE.fire(store=self.name, portion=portion_id,
                            nbytes=added, evicted=evicted)
        return added > 0

    def _evict_to_budget_locked(self, budget: int, keep=None) -> int:
        """Drop whole portions until the ledger fits the budget. Victim
        order: zone-pruned-away portions first (their zone maps keep
        proving scans don't need them — zero resident value), then
        coldest by (access heat, LRU tick). Caller holds the lock."""
        evicted = 0
        while self._nbytes > budget and self._info:
            candidates = [p for p in self._info if p != keep]
            if not candidates:
                break
            victim = min(
                candidates,
                key=lambda p: (-self._info[p]["zskips"],
                               self._info[p]["heat"],
                               self._info[p]["tick"]))
            self._drop_locked(victim)
            self.evictions += 1
            evicted += 1
        if evicted and _P_EVICT:
            _P_EVICT.fire(store=self.name, portions=evicted,
                          nbytes=self._nbytes)
        return evicted

    def _drop_locked(self, portion_id: int) -> None:
        info = self._info.pop(portion_id, None)
        if info is None:
            return
        for n in info["cols"]:
            e = self._cols.pop((portion_id, n), None)
            if e is not None:
                self._nbytes -= e.nbytes
        for t in info.get("tickets", ()):
            memsan.release(t, evicted=True)

    def promote_async(self, portion_id: int, rows: int, loader) -> bool:
        """Queue a promotion on the shared conveyor. ``loader()`` runs
        on a worker and returns (cols, valid) host dicts — either the
        in-memory arrays of a fresh portion write (eager path) or a
        blob-store read (heat path). Single-flight per portion id;
        bounded in-flight so queued promotions never crowd out scan
        prefetch admission."""
        if not self.enabled():
            return False
        with self._lock:
            if portion_id in self._inflight or \
                    len(self._inflight) >= MAX_INFLIGHT:
                return False
            self._inflight.add(portion_id)
            fh = leaksan.track("resident.flight",
                               f"{self.name}:{portion_id}")
            # compact finished handles while here (drain bookkeeping)
            self._pending = [h for h in self._pending
                             if not h.done.is_set()]

        def task():
            try:
                cols, valid = loader()
                self.promote(portion_id, rows, cols, valid)
            except Exception:
                # best-effort: a GC'd blob or a shrunk budget mid-task
                # is not a scan error — the host path still serves
                with self._lock:
                    self.errors += 1
            finally:
                with self._lock:
                    self._inflight.discard(portion_id)
                leaksan.close(fh)

        from ydb_tpu_torch.runtime.conveyor import shared_conveyor

        try:
            # promotions are background work owned by the STORE, not the
            # statement that triggered them: submit outside the
            # statement's deadline so a cancelled query can never strand
            # the _inflight entry (its discard lives in task()'s finally)
            with statement_deadline.activate(None):
                h = shared_conveyor().submit("resident_promote", task,
                                             priority=20)
        except RuntimeError:  # conveyor shut down (tests teardown)
            with self._lock:
                self._inflight.discard(portion_id)
            leaksan.close(fh)
            return False
        with self._lock:
            self._pending.append(h)
        return True

    def drain(self, timeout: float = 30.0) -> None:
        """Wait for every queued promotion (tests/bench determinism).
        Bounded: a wedged conveyor stops the wait at ``timeout``, it
        never wedges the caller."""
        import time

        deadline = time.monotonic() + timeout
        while True:
            with self._lock:
                pending = [h for h in self._pending
                           if not h.done.is_set()]
                self._pending = pending
            left = deadline - time.monotonic()
            if not pending or left <= 0:
                return
            pending[0].done.wait(left)

    # ---- invalidation ----

    def invalidate(self, portion_ids) -> None:
        """Drop by immutable portion id (GC'd portions that no snapshot
        can ever name again — compaction/TTL tombstones keep serving
        old-snapshot readers until then)."""
        with self._lock:
            for pid in portion_ids:
                if pid in self._info:
                    self._drop_locked(pid)
                    self.invalidations += 1
                self._miss_heat.pop(pid, None)

    def prune(self, live) -> None:
        """Keep only portions in ``live`` (the shard's portion map)."""
        with self._lock:
            for pid in [p for p in self._info if p not in live]:
                self._drop_locked(pid)
                self.invalidations += 1
            for pid in [p for p in self._miss_heat if p not in live]:
                del self._miss_heat[pid]

    def clear(self) -> None:
        with self._lock:
            for info in self._info.values():
                for t in info.get("tickets", ()):
                    memsan.release(t)
            self._cols.clear()
            self._info.clear()
            self._miss_heat.clear()
            self._nbytes = 0

    # ---- observability ----

    @property
    def nbytes(self) -> int:
        return self._nbytes

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "portions": len(self._info),
                "columns": len(self._cols),
                "bytes": self._nbytes,
                "budget": self.budget(),
                "hits": self.hits,
                "misses": self.misses,
                "promotions": self.promotions,
                "evictions": self.evictions,
                "spills": self.spills,
                "invalidations": self.invalidations,
                "errors": self.errors,
                "inflight": len(self._inflight),
            }


# ---------------- scan-side block assembly ----------------


def portion_loader(shard, meta):
    """Blob-store loader for heat promotions: full current schema, with
    schema-evolution NULLs projected exactly as the host path would."""
    names = tuple(shard.schema.names)

    def load():
        from ydb_tpu_torch.engine.portion import (project_chunk,
                                                  read_portion_blob)

        c, v = read_portion_blob(shard.store, meta.blob_id)
        return project_chunk(shard.schema, shard.column_added, meta,
                             names, c, v)

    return load


def scan_items(source, clusters, names, device=None):
    """One shard's scan stream as ('dev', entries, rows) /
    ('host', cols, valid) items, preserving global row order.

    Resident portions serve decoded device tensors; everything else
    (K-way dedup merges, cold portions, disabled stores) falls through
    to the existing host payload path mid-stream. Host-path portions
    count heat; crossing the threshold queues an async promotion so the
    NEXT scan finds them resident. The store serves only blocks bound
    for its own device (``device``; None = any)."""
    from ydb_tpu_torch.device import same_device

    shard = source.shard
    store = getattr(shard, "resident", None)
    on = (store is not None and store.enabled()
          and (device is None or same_device(store.device, device)))
    pk = shard.pk_column
    for cl in clusters:
        if source.dedup and pk is not None and len(cl) > 1:
            # a K-way newest-wins merge rewrites rows; its output is
            # not any single portion's columns — host path only
            for cols, valid in source._iter_merged(cl, names):
                yield ("host", cols, valid)
            continue
        for m in cl:
            if on:
                ent = store.lookup(m.portion_id, names)
                if ent is not None:
                    source.resident_hits += 1
                    source.resident_rows += m.num_rows
                    # bytes served straight from device memory — the
                    # movement the resident tier SAVED the staged
                    # pipeline
                    timeline.add_bytes("resident_bytes", sum(
                        e.nbytes for e in ent.values()))
                    yield ("dev", ent, m.num_rows)
                    continue
                if store.record_miss(m.portion_id):
                    store.promote_async(m.portion_id, m.num_rows,
                                        portion_loader(shard, m))
            for cols, valid in source._iter_plain([m], names):
                yield ("host", cols, valid)


def _device_blocks(run, names, sch, cap, timer, stager):
    """Cut a RUN of consecutive resident portions into
    capacity-``cap`` TableBlocks by device-side slice + concat, on the
    scan's side stream (``stager.assemble``).

    Coalescing across portion boundaries matters as much as skipping
    the host stage: emitting one padded block per small portion would
    hand the executor mostly-padding blocks and multiply compute by
    the portion count. The aligned case (one portion exactly filling a
    block) reuses the resident tensors as-is — zero device work."""
    stage = (timer.stage if timer is not None else None)
    starts = []
    total = 0
    for _, rows in run:
        starts.append(total)
        total += rows
    for off in range(0, total, cap):
        take = min(cap, total - off)
        # resident pieces overlapping [off, off+take), local coords
        parts = []
        for (entries, rows), s in zip(run, starts):
            lo = max(off, s) - s
            hi = min(off + take, s + rows) - s
            if lo < hi:
                parts.append((entries, lo, hi, rows))

        def build(side, parts=parts, take=take):
            whole = (len(parts) == 1 and parts[0][1] == 0
                     and parts[0][2] == parts[0][3] == cap)
            cols = {}
            dev = None
            for n in names:
                if whole:
                    e = parts[0][0][n]
                    d = staging.reading(e.data, side)
                    v = staging.reading(e.validity, side)
                else:
                    ds, vs = [], []
                    for entries, lo, hi, _rows in parts:
                        e = entries[n]
                        ds.append(staging.reading(e.data, side)
                                  .narrow(0, lo, hi - lo))
                        vs.append(staging.reading(e.validity, side)
                                  .narrow(0, lo, hi - lo))
                    if take < cap:
                        # tail-only pad; padding validity stays False
                        ds.append(ds[0].new_zeros(cap - take))
                        vs.append(vs[0].new_zeros(cap - take))
                    d = ds[0] if len(ds) == 1 else torch.cat(ds)
                    v = vs[0] if len(vs) == 1 else torch.cat(vs)
                dev = d.device
                cols[n] = Column(d, v)
            length = torch.full((), take, dtype=torch.int32, device=dev)
            return TableBlock(cols, length, sch)

        ctx = stage("stage") if stage is not None \
            else contextlib.nullcontext()
        with ctx:
            blk = stager.assemble(build)
        yield blk


def mixed_blocks(items, names, sch, cap, timer=None, stager=None,
                 device=None):
    """('dev'/'host') item stream -> fixed-capacity TableBlocks.

    Host runs pack through ``reader.rechunk`` (the same low-copy
    re-cutting as the pure host path); a device item flushes the
    pending host run as a partial block first, so row ORDER is exactly
    the host path's. Block BOUNDARIES may differ from the pure host
    stream (partial flushes at tier transitions) — programs are
    boundary-agnostic (fixed capacity + masked padding), only row order
    matters. Always emits at least one (possibly empty) block:
    consumers size their compiled programs off the stream. Blocks are
    built by ``stager`` (one per scan, on ``device``)."""
    from ydb_tpu_torch.engine.reader import rechunk

    if stager is None:
        stager = staging.Stager(device)

    def build(cols, valid):
        ctx = (timer.stage("stage") if timer is not None
               else contextlib.nullcontext())
        with ctx:
            blk = stager.from_numpy(cols, valid, sch, cap)
        timeline.add_bytes("staged_bytes", block_nbytes(blk))
        return blk

    it = iter(items)
    emitted = 0
    pending = None
    while True:
        item = pending if pending is not None else next(it, None)
        pending = None
        if item is None:
            break
        if item[0] == "dev":
            # absorb the whole consecutive resident run so blocks
            # coalesce across portion boundaries
            dev_run = [(item[1], item[2])]
            for nxt in it:
                if nxt[0] != "dev":
                    pending = nxt
                    break
                dev_run.append((nxt[1], nxt[2]))
            for blk in _device_blocks(dev_run, names, sch, cap, timer,
                                      stager):
                emitted += 1
                yield blk
            continue

        def host_run(first=item):
            nonlocal pending
            yield first[1], first[2]
            for nxt in it:
                if nxt[0] != "host":
                    pending = nxt
                    return
                yield nxt[1], nxt[2]

        for cols, valid in rechunk(host_run(), names, cap):
            emitted += 1
            yield build(cols, valid)
    if emitted == 0:
        yield build(
            {m: np.empty(0, dtype=sch.field(m).type.physical)
             for m in names},
            {m: np.empty(0, dtype=bool) for m in names})


def stream_resident(source, clusters, names, sch, cap,
                    timer=None, prefetch=True, device=None):
    """Resident-aware block stream for one PortionStreamSource, with the
    same conveyor-prefetch shape as ``reader.stream_blocks``: blob IO,
    host staging AND device assembly all run on a worker ahead of the
    consumer's compute."""
    from ydb_tpu_torch.engine.reader import pump_blocks

    gen = mixed_blocks(scan_items(source, clusters, names, device), names,
                       sch, cap, timer=timer, device=device)
    return pump_blocks(gen, prefetch=prefetch)
