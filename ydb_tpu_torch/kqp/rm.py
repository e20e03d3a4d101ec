"""KQP resource manager + workload service (admission control).

Mirror of the reference's per-node resource accounting and query
admission planes (ydb/core/kqp/rm_service/kqp_rm_service.h:82 — memory
/compute-slot budgets acquired per task and returned on completion,
with a cluster snapshot feeding the planner; ydb/core/kqp/
workload_service/kqp_workload_service.cpp:37 — named resource pools
with concurrent-query limits and bounded admission queues; SURVEY.md
§2.8 rows "resource manager" / "workload service").

ResourceManager: hard budgets; acquire either grants immediately or
fails (the caller queues/retries — the reference's task starts are
rejected the same way). Grants are tracked per query so release is
idempotent and crash-safe at the accounting level.

WorkloadService: admission by pool — running < limit admits; past the
limit requests wait in a bounded FIFO; past the queue bound they are
rejected (OVERLOADED). finish() promotes the queue head. Pools are
config-reloadable (Console dynamic-config shape).

The port's own copy of ``ydb_tpu/kqp/rm.py``, without the leak
sanitizer's per-grant handles (ROADMAP.md queue A, sanitizers).
"""

from __future__ import annotations

import collections
import threading



class ResourceExhausted(Exception):
    #: sys_top_queries error_reason tag (admission-plane rejection)
    reason = "overloaded"


class ResourceManager:
    """Per-node memory/slot budgets (kqp_rm_service analog)."""

    def __init__(self, memory_bytes: int = 1 << 30,
                 compute_slots: int = 8):
        self.memory_bytes = memory_bytes
        self.compute_slots = compute_slots
        self._lock = threading.Lock()
        self._grants: dict[str, tuple[int, int]] = {}

    def used(self) -> tuple[int, int]:
        with self._lock:
            mem = sum(m for m, _s in self._grants.values())
            slots = sum(s for _m, s in self._grants.values())
            return mem, slots

    def acquire(self, query_id: str, memory: int = 0,
                slots: int = 1) -> None:
        with self._lock:
            cur_m, cur_s = 0, 0
            for m, s in self._grants.values():
                cur_m += m
                cur_s += s
            old = self._grants.get(query_id, (0, 0))
            new_m = cur_m - old[0] + memory
            new_s = cur_s - old[1] + slots
            if new_m > self.memory_bytes:
                raise ResourceExhausted(
                    f"memory: want {memory}, "
                    f"free {self.memory_bytes - cur_m + old[0]}")
            if new_s > self.compute_slots:
                raise ResourceExhausted(
                    f"slots: want {slots}, "
                    f"free {self.compute_slots - cur_s + old[1]}")
            self._grants[query_id] = (memory, slots)

    def release(self, query_id: str) -> None:
        with self._lock:
            self._grants.pop(query_id, None)

    def snapshot(self) -> dict:
        """Planner feed (resource info exchange analog)."""
        mem, slots = self.used()
        return {
            "memory_bytes": self.memory_bytes,
            "memory_used": mem,
            "compute_slots": self.compute_slots,
            "slots_used": slots,
            "queries": len(self._grants),
        }


class PoolOverloaded(Exception):
    #: sys_top_queries error_reason tag
    reason = "overloaded"


class OverloadedError(Exception):
    """The cluster shed this statement at admission: past the
    configured in-flight limit the session layer fails fast with this
    typed error instead of queueing unboundedly (load shedding — the
    serving tier's backpressure signal to clients)."""

    reason = "overloaded"


class _Pool:
    def __init__(self, name: str, concurrent_limit: int,
                 queue_size: int):
        self.name = name
        self.limit = concurrent_limit
        self.queue_size = queue_size
        self.running: set[str] = set()
        self.queue: collections.deque = collections.deque()
        self.stats = {"admitted": 0, "queued": 0, "rejected": 0}


class WorkloadService:
    """Named admission pools (kqp_workload_service analog)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._freed = threading.Condition(self._lock)
        self._pools: dict[str, _Pool] = {}
        self.configure("default", concurrent_limit=16, queue_size=64)

    def configure(self, pool: str, concurrent_limit: int,
                  queue_size: int = 64) -> None:
        with self._lock:
            p = self._pools.get(pool)
            if p is None:
                self._pools[pool] = _Pool(pool, concurrent_limit,
                                          queue_size)
            else:
                p.limit = concurrent_limit
                p.queue_size = queue_size

    def _pool(self, pool: str) -> _Pool:
        p = self._pools.get(pool)
        if p is None:
            raise KeyError(f"no resource pool {pool}")
        return p

    def admit(self, query_id: str, pool: str = "default") -> bool:
        """True = running now; False = queued (caller waits for its
        turn via poll()). Raises PoolOverloaded past the queue bound."""
        with self._lock:
            p = self._pool(pool)
            if query_id in p.running:
                return True
            if len(p.running) < p.limit and not p.queue:
                p.running.add(query_id)
                p.stats["admitted"] += 1
                return True
            if len(p.queue) >= p.queue_size:
                p.stats["rejected"] += 1
                raise PoolOverloaded(
                    f"pool {pool}: {len(p.running)} running, "
                    f"queue full ({p.queue_size})")
            p.queue.append(query_id)
            p.stats["queued"] += 1
            return False

    def poll(self, query_id: str, pool: str = "default") -> bool:
        """True once the queued query reaches the front and a slot is
        free (it is then admitted)."""
        with self._lock:
            p = self._pool(pool)
            if query_id in p.running:
                return True
            if (p.queue and p.queue[0] == query_id
                    and len(p.running) < p.limit):
                p.queue.popleft()
                p.running.add(query_id)
                p.stats["admitted"] += 1
                return True
            return False

    def wait_admitted(self, query_id: str, pool: str = "default",
                      timeout: float = 30.0) -> bool:
        """Block (condition-waited, not busy-polled) until the queued
        query is admitted; False on timeout (caller must finish())."""
        import time

        deadline = time.monotonic() + timeout
        with self._lock:
            while True:
                p = self._pool(pool)
                if query_id in p.running:
                    return True
                if (p.queue and p.queue[0] == query_id
                        and len(p.running) < p.limit):
                    p.queue.popleft()
                    p.running.add(query_id)
                    p.stats["admitted"] += 1
                    self._freed.notify_all()
                    return True
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return False
                self._freed.wait(remaining)

    def finish(self, query_id: str, pool: str = "default") -> None:
        with self._lock:
            p = self._pool(pool)
            p.running.discard(query_id)
            try:
                p.queue.remove(query_id)  # cancelled while queued
            except ValueError:
                pass
            self._freed.notify_all()

    def stats(self, pool: str = "default") -> dict:
        with self._lock:
            p = self._pool(pool)
            return dict(p.stats, running=len(p.running),
                        queued=len(p.queue), limit=p.limit)

    def pools(self) -> dict[str, dict]:
        """All pools' stats in one locked pass (the front door's
        ``sys_tenant_pools`` view joins these against its seat
        counters)."""
        with self._lock:
            return {name: dict(p.stats, running=len(p.running),
                               queued=len(p.queue), limit=p.limit)
                    for name, p in self._pools.items()}
