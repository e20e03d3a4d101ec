"""Kesus: distributed coordination tablet (semaphores, locks,
sessions) + SequenceShard (durable sequence ranges).

Mirror of the reference's coordination service and sequence tablet
(ydb/core/kesus/tablet: sessions, semaphores with counts/waiter
queues, ephemeral locks released on session death;
ydb/core/tx/sequenceshard: hi-lo durable sequence allocation;
SURVEY.md §2.5 "Sequences / Kesus / Locks"). Both are ordinary
tablets over the executor: every mutation is a WAL-committed
transaction, so coordination state (who holds which semaphore, the
next sequence range) survives reboot and moves with the tablet.

Semantics:
  * sessions attach with a timeout; ``tick(now)`` expires them and
    releases everything they held (the failure-recovery contract);
  * a semaphore has a ``limit``; acquire(count) succeeds when the sum
    of held counts + count <= limit, else the session queues as a
    waiter (FIFO) and is promoted on release; waiters carry their own
    deadline and lapse out of the queue un-promoted;
  * ephemeral semaphores (locks) are created on first acquire and
    vanish when the last holder releases — the distributed-lock shape;
  * sequences allocate a durable range of ``cache`` values per refill
    (either direction of increment), so a crash skips at most one
    range and never repeats a value.

The port's own copy of ``ydb_tpu/tablet/kesus.py``, over the port's
``tablet/executor.py``: the same tablet ids (``kesus/<id>``,
``sequence/<id>``), tables and redo blobs, so a store whose Kesus or
sequence state either package wrote boots in the other.
"""

from __future__ import annotations

import threading
import time

from ydb_tpu_torch.engine.blobs import BlobStore
from ydb_tpu_torch.tablet.executor import TabletExecutor


class KesusTablet:
    """Sessions + semaphores with durable state."""

    def __init__(self, tablet_id: str, store: BlobStore, now=time.time):
        self.executor = TabletExecutor.boot(f"kesus/{tablet_id}", store)
        self.now = now

    # ---- sessions ----

    def attach_session(self, timeout_s: float = 30.0,
                       description: str = "") -> int:
        def fn(txc):
            meta = self.executor.db.table("meta").get(("next_session",))
            sid = meta["v"] if meta else 1
            txc.put("meta", ("next_session",), {"v": sid + 1})
            txc.put("sessions", (sid,), {
                "timeout": timeout_s,
                "deadline": self.now() + timeout_s,
                "description": description,
            })
            return sid
        return self.executor.run(fn)

    def ping_session(self, sid: int) -> bool:
        def fn(txc):
            row = txc.get("sessions", (sid,))
            if row is None:
                return False
            txc.put("sessions", (sid,), dict(
                row, deadline=self.now() + row["timeout"]))
            return True
        return self.executor.run(fn)

    def detach_session(self, sid: int) -> None:
        self.executor.run(
            lambda txc: self._drop_session(txc, sid, frozenset({sid})))

    def _drop_session(self, txc, sid: int, dead: frozenset) -> None:
        """Drop one session. ``dead`` is the full set of sessions being
        dropped in THIS transaction: promotions must skip them (the
        localdb view inside a tx is the committed state, so an erased
        co-dead session still looks alive to reads)."""
        txc.erase("sessions", (sid,))
        for (name, pos), row in list(
                self.executor.db.table("waiters").range()):
            if row["session"] == sid:
                txc.erase("waiters", (name, pos))
        for (name, holder), _row in list(
                self.executor.db.table("holds").range()):
            if holder == sid:
                self._release_one(txc, sid, name, skip=dead)

    def tick(self, now: float | None = None) -> list[int]:
        """Expire dead sessions (releasing their holds) and lapsed
        waiters (failure detection + recovery for coordination state)."""
        now = self.now() if now is None else now

        def fn(txc):
            for (name, pos), row in list(
                    self.executor.db.table("waiters").range()):
                if row["deadline"] < now:
                    txc.erase("waiters", (name, pos))
            dead = frozenset(
                sid for (sid,), row in
                self.executor.db.table("sessions").range()
                if row["deadline"] < now)
            for sid in dead:
                self._drop_session(txc, sid, dead)
            return sorted(dead)
        return self.executor.run(fn)

    # ---- semaphores ----

    def create_semaphore(self, name: str, limit: int,
                         data: str = "") -> None:
        def fn(txc):
            if txc.get("semaphores", (name,)) is not None:
                raise ValueError(f"semaphore {name} exists")
            txc.put("semaphores", (name,), {
                "limit": limit, "data": data, "ephemeral": False,
                "next_waiter": 0,
            })
        self.executor.run(fn)

    def delete_semaphore(self, name: str) -> None:
        def fn(txc):
            holds = [k for k, _ in
                     self.executor.db.table("holds").range()
                     if k[0] == name]
            if holds:
                raise ValueError(f"semaphore {name} is held")
            for (n, pos), _row in list(
                    self.executor.db.table("waiters").range()):
                if n == name:  # stale waiters must not survive into a
                    txc.erase("waiters", (n, pos))  # recreated name
            txc.erase("semaphores", (name,))
        self.executor.run(fn)

    def _held(self, name: str, exclude: frozenset = frozenset()) -> int:
        return sum(row["count"] for (n, sid), row in
                   self.executor.db.table("holds").range()
                   if n == name and sid not in exclude)

    def acquire(self, sid: int, name: str, count: int = 1,
                ephemeral: bool = False, timeout_s: float = 0.0) -> bool:
        """True = acquired now; False = queued as waiter (or rejected
        when timeout_s == 0 and the semaphore is full)."""
        def fn(txc):
            if txc.get("sessions", (sid,)) is None:
                raise ValueError(f"no session {sid}")
            sem = txc.get("semaphores", (name,))
            if sem is None:
                if not ephemeral:
                    raise ValueError(f"no semaphore {name}")
                sem = {"limit": count, "data": "", "ephemeral": True,
                       "next_waiter": 0}
                txc.put("semaphores", (name,), sem)
            cur = txc.get("holds", (name, sid))
            if cur is not None:
                return True  # re-acquire is idempotent
            for (n, _pos), row in \
                    self.executor.db.table("waiters").range():
                if n == name and row["session"] == sid:
                    return False  # already queued: no duplicate waiter
            if self._held(name) + count <= sem["limit"]:
                txc.put("holds", (name, sid), {"count": count})
                return True
            if timeout_s <= 0:
                return False
            pos = sem["next_waiter"]
            txc.put("semaphores", (name,), dict(
                sem, next_waiter=pos + 1))
            txc.put("waiters", (name, pos), {
                "session": sid, "count": count,
                "deadline": self.now() + timeout_s,
            })
            return False
        return self.executor.run(fn)

    def release(self, sid: int, name: str) -> list[int]:
        """Release; returns sessions promoted from the waiter queue."""
        return self.executor.run(
            lambda txc: self._release_one(txc, sid, name))

    def _release_one(self, txc, sid: int, name: str,
                     skip: frozenset = frozenset()) -> list[int]:
        if self.executor.db.table("holds").get((name, sid)) is None:
            return []
        txc.erase("holds", (name, sid))
        sem = txc.get("semaphores", (name,))
        promoted = []
        now = self.now()
        # remaining held count, excluding the hold just erased and any
        # co-dropping sessions (in-tx erasures are invisible to reads)
        held = self._held(name, exclude=skip | {sid})
        for (n, pos), row in list(
                self.executor.db.table("waiters").range()):
            if n != name:
                continue
            if row["session"] in skip or row["deadline"] < now:
                txc.erase("waiters", (n, pos))
                continue
            if held + row["count"] <= sem["limit"]:
                txc.erase("waiters", (n, pos))
                txc.put("holds", (name, row["session"]),
                        {"count": row["count"]})
                held += row["count"]
                promoted.append(row["session"])
        if sem is not None and sem["ephemeral"] and held == 0 \
                and not promoted:
            # fully-released ephemeral lock vanishes; any never-
            # promotable waiters must go with it, or they would
            # resurrect under an unrelated recreation of the name
            for (n, pos), _row in list(
                    self.executor.db.table("waiters").range()):
                if n == name:
                    txc.erase("waiters", (n, pos))
            txc.erase("semaphores", (name,))
        return promoted

    def describe(self, name: str) -> dict:
        sem = self.executor.db.table("semaphores").get((name,))
        if sem is None:
            raise KeyError(name)
        owners = {sid: row["count"] for (n, sid), row in
                  self.executor.db.table("holds").range() if n == name}
        waiters = [row["session"] for (n, _pos), row in
                   self.executor.db.table("waiters").range()
                   if n == name]
        return {"limit": sem["limit"], "data": sem["data"],
                "ephemeral": sem["ephemeral"], "owners": owners,
                "waiters": waiters}


class SequenceShard:
    """Durable sequence allocator (hi-lo ranges, either direction)."""

    def __init__(self, tablet_id: str, store: BlobStore):
        self.executor = TabletExecutor.boot(
            f"sequence/{tablet_id}", store)
        # name -> (next_value, values_remaining, increment); the lock
        # serializes the cache's read-modify-write so concurrent
        # nextval callers never receive the same value
        self._cache: dict[str, tuple[int, int, int]] = {}
        self._lock = threading.Lock()

    def create_sequence(self, name: str, start: int = 1,
                        increment: int = 1, cache: int = 100) -> None:
        if increment == 0:
            raise ValueError("increment must be nonzero")
        if cache < 1:
            # cache 0 would never advance the durable counter: every
            # nextval would return the same value forever
            raise ValueError("cache must be >= 1")

        def fn(txc):
            if txc.get("sequences", (name,)) is not None:
                raise ValueError(f"sequence {name} exists")
            txc.put("sequences", (name,), {
                "next": start, "increment": increment, "cache": cache,
            })
        self.executor.run(fn)

    def drop_sequence(self, name: str) -> None:
        def fn(txc):
            txc.erase("sequences", (name,))
        self.executor.run(fn)
        # a nextval caching a fresh range concurrently with the drop
        # must not resurrect the entry after this pop
        with self._lock:
            self._cache.pop(name, None)

    def next_val(self, name: str) -> int:
        with self._lock:
            val, remaining, inc = self._cache.get(name, (0, 0, 1))
            if remaining <= 0:
                def fn(txc):
                    row = txc.get("sequences", (name,))
                    if row is None:
                        raise KeyError(f"no sequence {name}")
                    nxt = row["next"]
                    top = nxt + row["cache"] * row["increment"]
                    txc.put("sequences", (name,), dict(row, next=top))
                    return nxt, row["cache"], row["increment"]
                # the whole range is durable BEFORE any value is handed
                # out
                val, remaining, inc = self.executor.run(fn)
            self._cache[name] = (val + inc, remaining - 1, inc)
            return val
