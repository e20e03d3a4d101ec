"""Device-resident decoded-block cache.

The port of ``ydb_tpu/engine/blockcache.py``: entries hold torch
``TableBlock``s on the scan's device, and the auto budget is on when
CUDA is available (the reference asks ``jax.default_backend()``).
The accelerator lift of the reference's shared page cache
(ydb/core/tablet_flat/shared_sausagecache.cpp:194): warm scans reuse
decoded column blocks pinned in accelerator HBM, skipping blob IO, the
host-side decode/PK-merge, and the host->device transfer. Entries key on
IMMUTABLE inputs (portion ids + read columns + block geometry), so a
commit/compaction/TTL rewrite simply produces a different key: old
snapshots keep hitting their own entries, and entries whose portions are
gone free eagerly via ``prune``.

Used by ColumnShard.scan (single-shard scans) and by the plan executor's
TableScan over MultiShardStreamSource (the SQL path, one cache per
Cluster).
"""

from __future__ import annotations

import collections
import os
import threading

from ydb_tpu_torch.analysis import leaksan, sanitizer

#: single-flight wait bound: a filler stuck past this (wedged blob
#: store, debugger) stops blocking waiters — they fill uncached instead
FLIGHT_WAIT_SECONDS = 30.0


def default_budget(device=None) -> int:
    """Auto budget: on when the blocks live on a CUDA device (``device``,
    CUDA when None), off for CPU blocks (there the "device" is host RSS
    and the out-of-core tests own that bound)."""
    import torch

    from ydb_tpu_torch.device import DEFAULT_DEVICE

    dev = torch.device(DEFAULT_DEVICE if device is None else device)
    return (DeviceBlockCache.AUTO_BYTES
            if dev.type == "cuda" and torch.cuda.is_available() else 0)


class DeviceBlockCache:
    AUTO_BYTES = 4 << 30
    MAX_ENTRIES = 32

    def __init__(self, budget: "int | None" = None, device=None):
        # budget None = resolve default_budget() per use (it can change
        # with the environment in tests); ``device`` is where the cached
        # blocks live, which picks the auto budget
        self._budget = budget
        self.device = device
        # sanitizer-tracked under YDB_TPU_TORCH_TSAN=1 (a per-instance
        # name: distinct caches must not share lockset state)
        self._entries = sanitizer.share(
            collections.OrderedDict(), f"blockcache.{id(self):x}")
        self._nbytes = 0
        self._lock = sanitizer.make_lock(f"blockcache.{id(self):x}.lock")
        # key -> threading.Event: per-key in-flight fills (single-flight
        # dedup — concurrent scans missing the same key must not both
        # decode and both tee)
        self._flights = sanitizer.share(
            {}, f"blockcache.{id(self):x}.flights")
        self.hits = 0
        self.misses = 0
        self.flight_waits = 0

    def budget(self) -> int:
        """YDB_TPU_TORCH_SCAN_CACHE_BYTES overrides EVERYTHING (including an
        explicitly configured budget — the operator's emergency valve
        for HBM pressure); malformed values disable rather than poison
        the read path. Otherwise the constructor budget, else auto."""
        env = os.environ.get("YDB_TPU_TORCH_SCAN_CACHE_BYTES")
        if env is not None:
            try:
                return int(env)
            except ValueError:
                return 0
        return self._budget if self._budget is not None \
            else default_budget(self.device)

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()
            self._nbytes = 0

    def __len__(self) -> int:
        return len(self._entries)

    def __iter__(self):
        return iter(list(self._entries))

    @property
    def nbytes(self) -> int:
        return self._nbytes

    def get(self, key):
        """Cached block list or None; hit refreshes LRU order."""
        with self._lock:
            ent = self._entries.get(key)
            if ent is None:
                self.misses += 1
                return None
            self._entries.move_to_end(key)
            self.hits += 1
            return ent[0]

    def prune(self, alive) -> None:
        """Drop entries whose key fails ``alive(key)`` — e.g. entries
        referencing GC'd portions that no snapshot can name again."""
        with self._lock:
            for k in [k for k in self._entries if not alive(k)]:
                self._nbytes -= self._entries.pop(k)[1]

    def tee(self, blocks, key):
        """Yield ``blocks`` unchanged while collecting them for the
        cache. Collection aborts (releasing already-pinned blocks) the
        moment the running size exceeds the budget, so an over-budget
        scan never pins more device memory than an uncached one."""
        budget = self.budget()
        collected: "list | None" = []
        nbytes = 0
        # pass-through collection loop: bounded by BLOCK count (the
        # morsel stream), device refs only — no per-row work, no copy
        # ydb-lint: disable=H006
        for b in blocks:
            if collected is not None:
                nbytes += sum(
                    int(c.data.nbytes) + int(c.validity.nbytes)
                    for c in b.columns.values())
                if nbytes > budget:
                    collected = None
                else:
                    collected.append(b)
            yield b
        if collected is not None:
            with self._lock:
                old = self._entries.pop(key, None)
                if old is not None:
                    self._nbytes -= old[1]
                self._entries[key] = (collected, nbytes)
                self._nbytes += nbytes
                # byte budget + entry cap: commit-heavy workloads mint a
                # fresh key per commit; stale-but-live entries must not
                # pile up in device memory
                while ((self._nbytes > budget
                        or len(self._entries) > self.MAX_ENTRIES)
                       and len(self._entries) > 1):
                    _, (_, nb) = self._entries.popitem(last=False)
                    self._nbytes -= nb

    def stream(self, key, make_blocks):
        """Cached stream for ``key``: the cached blocks when present,
        else ``make_blocks()`` teed into the cache with per-key
        single-flight dedup — the first scan to miss fills; concurrent
        scans on the same key wait for its entry instead of each
        decoding and teeing their own copy. When the budget is off, the
        raw stream passes through untouched."""
        if self.budget() <= 0 or key is None:
            return make_blocks()
        return self._stream_gen(key, make_blocks)

    def _stream_gen(self, key, make_blocks):
        """Flight registration happens INSIDE the generator body (on
        first next()): a generator handed back but never iterated runs
        no ``finally``, so registering before returning it could strand
        the flight and wedge every waiter."""
        while True:
            with self._lock:
                ent = self._entries.get(key)
                if ent is not None:
                    self._entries.move_to_end(key)
                    self.hits += 1
                    blocks = ent[0]
                    ev = None
                elif key not in self._flights:
                    # we are the filler
                    self._flights[key] = threading.Event()
                    fh = leaksan.track("blockcache.flight",
                                       str(key)[:80])
                    blocks = None
                    ev = None
                else:
                    ev = self._flights[key]
                    self.flight_waits += 1
            if ev is not None:
                if not ev.wait(FLIGHT_WAIT_SECONDS):
                    # wedged filler: serve uncached rather than stall
                    with self._lock:
                        self.misses += 1
                    yield from make_blocks()
                    return
                continue  # filler done — re-check the entry
            if blocks is not None:
                yield from blocks
                return
            try:
                with self._lock:
                    self.misses += 1
                yield from self.tee(make_blocks(), key)
            finally:
                # wake waiters whether the fill landed, overflowed the
                # budget, or the consumer abandoned the stream early —
                # they re-check and fill (or wait) themselves
                with self._lock:
                    ev = self._flights.pop(key, None)
                leaksan.close(fh)
                if ev is not None:
                    ev.set()
            return
