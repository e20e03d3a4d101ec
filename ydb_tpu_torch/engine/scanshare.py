"""Per-scan single-flight staging share (the batch tier's scan attach).

The DeviceBlockCache (engine/blockcache.py) single-flights the DECODE
of a portion stream per cache key; this module lifts the same
single-flight discipline one level up, to the fused executor's STAGED
block — the shape-class-padded device block a whole scan site stages
into (``plan_fuse.fit_blocks`` / ``TableBlock.from_numpy``). N
concurrent statements scanning the same hot table under the same
snapshot attach to ONE in-flight staging instead of each merging and
padding their own copy: the first arrival stages, everyone else waits
on the flight and reads the same device block.

Keys must capture everything that shapes the staged block: table,
pushdown program (pruning derives from it), read columns, shape-class
capacity, and the source's ``device_cache_key`` (per-shard visible
portion ids — a commit mints a new key, so stale entries are never
served; they just stop being asked for). Sources without a device cache
key (host ColumnSources outside a cluster) don't share — the caller
passes ``key=None`` and stages privately.

Entries are single-flight ONLY: an entry exists while its staging is in
flight and for the short tail while waiters collect it; completed
entries age out after ``linger_seconds``. Persistence across statements
belongs to the layers below (DeviceBlockCache, the resident tier) —
this share must never become a second cache holding device bytes twice.

Shared blocks are handed to dispatches that never write them: the
port's ``FusedPlan.run_shared`` and ``run_stacked`` copy staged blocks
into their graphs' static inputs (the port never donates).

The port's own copy of ``ydb_tpu/engine/scanshare.py``, without the
leak sanitizer's handle per flight (ROADMAP.md queue A, sanitizers).
"""

from __future__ import annotations

import threading
import time


#: a filler stuck past this (wedged blob store) stops blocking
#: attachers — they stage privately instead (blockcache idiom)
FLIGHT_WAIT_SECONDS = 30.0


class _Flight:
    __slots__ = ("event", "block", "error", "done_at")

    def __init__(self):
        self.event = threading.Event()
        self.block = None
        self.error = None
        self.done_at = None


class ScanShare:
    """Single-flight map: scan identity -> in-flight staged block."""

    def __init__(self, linger_seconds: float = 0.05):
        self.linger_seconds = linger_seconds
        self._lock = threading.Lock()
        self._flights: dict = {}
        self.staged = 0    # stage_fn actually ran
        self.attached = 0  # served from another statement's flight

    def get_or_stage(self, key, stage_fn):
        """The staged block for ``key``: the first caller runs
        ``stage_fn()`` (outside the lock) and publishes; concurrent
        callers wait on the flight and share the result. ``key=None``
        bypasses sharing entirely. A failed staging propagates its
        error to every attacher of THAT flight, then clears."""
        if key is None:
            return stage_fn()
        now = time.monotonic()
        with self._lock:
            self._sweep(now)
            fl = self._flights.get(key)
            if fl is None:
                fl = _Flight()
                self._flights[key] = fl
                filler = True
            else:
                filler = False
                self.attached += 1
        if not filler:
            if not fl.event.wait(FLIGHT_WAIT_SECONDS):
                # wedged filler: stage privately rather than stall
                return stage_fn()
            if fl.error is not None:
                raise fl.error
            return fl.block
        try:
            fl.block = stage_fn()
            self.staged += 1
            return fl.block
        except BaseException as e:
            fl.error = e
            raise
        finally:
            fl.done_at = time.monotonic()
            if fl.error is not None:
                # failed flights clear immediately: the next statement
                # must retry the staging, not inherit the error
                with self._lock:
                    self._flights.pop(key, None)
            fl.event.set()

    def _sweep(self, now: float) -> None:
        # drop completed flights past their linger window (under _lock)
        dead = [k for k, fl in self._flights.items()
                if fl.done_at is not None
                and now - fl.done_at > self.linger_seconds]
        for k in dead:
            self._flights.pop(k, None)

    def snapshot(self) -> dict:
        with self._lock:
            return {"staged": self.staged, "attached": self.attached,
                    "inflight": sum(
                        1 for fl in self._flights.values()
                        if fl.done_at is None)}

    def clear(self) -> None:
        """Drop completed flights (DDL invalidation is not needed —
        keys are snapshot-scoped — but tests want a clean slate)."""
        with self._lock:
            for k in [k for k, fl in self._flights.items()
                      if fl.done_at is not None]:
                self._flights.pop(k, None)
