"""The front door: one cross-client admission plane over the session
layer.

Every statement — arriving over pgwire (api/pgwire.py), the gRPC-style
proxy (api/server.py) or an in-process ``Session`` — passes through
``FrontDoor.admit`` before the workload-service pool and rm slots, so:

  * the batch window (kqp/batch.py) sees the *full* cross-client
    queue: admitted statements from different network connections
    co-occupy the window and compatible SELECTs share one device
    dispatch;
  * shedding is per tenant, not global: each tenant pool has its own
    inflight cap and bounded admission queue, and the typed
    ``OverloadedError`` names the pool — one tenant's backlog queues
    (and sheds) against its own cap while other tenants admit freely;
  * queued admissions are ordered earliest-deadline-first *within* a
    tenant, and an admission whose statement deadline has already
    expired is shed instead of consuming a grant.

``install()`` additionally splits the shared execution budgets by
tenant weight: per-tenant workload-service pools (concurrency), a
``tenant:<name>`` quota row on the shared conveyor's ResourceBroker,
and a resident-store byte entitlement (reported on ``sys_tenant_pools``
and enforced at promotion time by the resident tier's global budget).

The port's own copy of ``ydb_tpu/serving/admission.py``, with the leak
sanitizer's handle per seat. Left out until ROADMAP.md queue A item 7:
the ``serving.admit`` chaos site. The resident entitlement is
a share of the resident tier's budget on the cluster's device.
"""

from __future__ import annotations

import heapq
import os
import threading
import time

from ydb_tpu_torch.analysis import leaksan
from ydb_tpu_torch.kqp.rm import OverloadedError, WorkloadService
from ydb_tpu_torch.serving.tenants import DEFAULT_TENANT, TenantRegistry

#: states a queued admission moves through (guarded by FrontDoor._lock)
_WAITING, _GRANTED, _SHED = 0, 1, 2


class _Waiter:
    __slots__ = ("key", "state")

    def __init__(self, key: tuple):
        self.key = key
        self.state = _WAITING

    def __lt__(self, other: "_Waiter") -> bool:
        return self.key < other.key


class Seat:
    """One admitted statement's hold on its tenant pool (release once;
    idempotent so error paths may race the happy path)."""

    __slots__ = ("tenant", "_door", "_leak", "_released")

    def __init__(self, tenant: str, door: "FrontDoor", leak=None):
        self.tenant = tenant
        self._door = door
        self._leak = leak
        self._released = False

    def release(self) -> None:
        if self._released:
            return
        self._released = True
        leaksan.close(self._leak)
        self._door._release(self.tenant)


class _TenantState:
    def __init__(self, cap: int, queue_size: int):
        self.cap = cap
        self.queue_size = queue_size
        self.inflight = 0
        self.waiting = 0
        self.heap: list[_Waiter] = []
        self.cond: threading.Condition | None = None
        self.admitted = 0
        self.queued = 0
        self.shed = 0


class FrontDoor:
    """Per-tenant admission seats + weighted budget shares (see module
    docstring). One instance per Cluster, attached as
    ``cluster.front_door`` by :meth:`install`."""

    def __init__(self, cluster, registry: TenantRegistry | None = None):
        self.cluster = cluster
        self.registry = registry or TenantRegistry()
        self._lock = threading.Lock()
        self._states: dict[str, _TenantState] = {}
        self._seq = 0
        self.shares: dict[str, dict] = {}

    # -- wiring ---------------------------------------------------------

    def install(self) -> "FrontDoor":
        """Attach to the cluster and apply weighted shares: per-tenant
        workload pools, broker quota rows, resident byte entitlements."""
        c = self.cluster
        if c.workload is None:
            c.workload = WorkloadService()
        pool_total = int(os.environ.get(
            "YDB_TPU_TORCH_SERVING_POOL_SLOTS", "16"))
        pool_shares = self.registry.shares(pool_total)
        from ydb_tpu_torch.engine import resident
        from ydb_tpu_torch.runtime.conveyor import shared_conveyor
        conv = shared_conveyor()
        workers = int(os.environ.get("YDB_TPU_TORCH_CONVEYOR_WORKERS", "4"))
        worker_shares = self.registry.shares(max(1, workers))
        resident_total = resident.default_budget(
            getattr(c, "device", None))
        resident_shares = self.registry.shares(resident_total) \
            if resident_total > 0 else {}
        for t in self.registry.tenants():
            c.workload.configure(t.name,
                                 concurrent_limit=pool_shares[t.name],
                                 queue_size=t.queue_size)
            conv.broker.quotas[f"tenant:{t.name}"] = \
                worker_shares[t.name]
            self.shares[t.name] = {
                "weight": t.weight,
                "pool_limit": pool_shares[t.name],
                "conveyor_workers": worker_shares[t.name],
                "resident_bytes": resident_shares.get(t.name, 0),
            }
        c.front_door = self
        return self

    def _state(self, tenant: str) -> _TenantState:
        st = self._states.get(tenant)
        if st is None:
            t = self.registry.get(tenant)
            st = _TenantState(t.max_inflight, t.queue_size)
            st.cond = threading.Condition(self._lock)
            self._states[tenant] = st
        return st

    # -- admission ------------------------------------------------------

    def admit(self, tenant: str | None, deadline_at: float | None = None,
              timeout: float = 30.0, owner=None) -> Seat:
        """Block until the tenant pool has a free seat; raise the typed
        ``OverloadedError`` (naming the pool) when the pool's queue is
        full, the wait times out, or the statement deadline expires
        while queued."""
        name = tenant or DEFAULT_TENANT
        give_up = time.monotonic() + timeout
        if deadline_at is not None:
            give_up = min(give_up, deadline_at)
        with self._lock:
            st = self._state(name)
            while st.heap and st.heap[0].state != _WAITING:
                heapq.heappop(st.heap)  # lazily drop shed waiters
            if st.inflight < st.cap and not st.heap:
                st.inflight += 1
                st.admitted += 1
                return self._seat(name, owner)
            if st.waiting >= st.queue_size:
                st.shed += 1
                self._count_locked(name, "shed")
                raise OverloadedError(
                    f"tenant pool '{name}' overloaded: "
                    f"{st.inflight} inflight (cap {st.cap}), "
                    f"queue full ({st.queue_size})")
            # earliest-deadline-first within the tenant; FIFO among
            # deadline-less statements (seq breaks ties)
            self._seq += 1
            w = _Waiter((deadline_at if deadline_at is not None
                         else float("inf"), self._seq))
            heapq.heappush(st.heap, w)
            st.waiting += 1
            st.queued += 1
            self._promote(st)  # capacity may be free for the new head
            try:
                while w.state == _WAITING:
                    remaining = give_up - time.monotonic()
                    if remaining <= 0:
                        w.state = _SHED
                        break
                    st.cond.wait(remaining)
            finally:
                st.waiting -= 1
            if w.state != _GRANTED:
                st.shed += 1
                self._count_locked(name, "shed")
                raise OverloadedError(
                    f"tenant pool '{name}': admission wait "
                    f"expired after {timeout:.1f}s")
            st.admitted += 1
            return self._seat(name, owner)

    def _seat(self, name: str, owner) -> Seat:
        self._count_locked(name, "admitted")
        return Seat(name, self,
                    leaksan.track("serving.seat", name, owner=owner))

    def _release(self, tenant: str) -> None:
        with self._lock:
            st = self._states.get(tenant)
            if st is None:
                return
            st.inflight -= 1
            self._promote(st)

    def _promote(self, st: _TenantState) -> None:
        """Grant freed seats earliest-deadline-first; expired waiters
        are shed here so they never consume a grant."""
        now = time.monotonic()
        woke = False
        while st.inflight < st.cap and st.heap:
            w = heapq.heappop(st.heap)
            if w.state != _WAITING:
                continue
            if w.key[0] <= now:
                w.state = _SHED
                woke = True
                continue
            w.state = _GRANTED
            st.inflight += 1
            woke = True
        if woke:
            st.cond.notify_all()

    # -- observability --------------------------------------------------

    def _count(self, tenant: str, which: str) -> None:
        with self._lock:
            self._count_locked(tenant, which)

    def _count_locked(self, tenant: str, which: str) -> None:
        c = getattr(self.cluster, "counters", None)
        if c is not None:
            c.group(component="serving",
                    tenant=tenant).counter(which).inc()

    def snapshot(self) -> dict:
        """Per-tenant admission state for ``sys_tenant_pools`` and the
        background counter export."""
        out: dict = {}
        with self._lock:
            names = set(self._states) | set(self.shares) \
                | {t.name for t in self.registry.tenants()}
            for name in sorted(names):
                st = self._states.get(name)
                t = self.registry.get(name)
                share = self.shares.get(name, {})
                out[name] = {
                    "weight": share.get("weight", t.weight),
                    "inflight": st.inflight if st else 0,
                    "max_inflight": t.max_inflight,
                    "queued": st.waiting if st else 0,
                    "queue_size": t.queue_size,
                    "admitted": st.admitted if st else 0,
                    "shed": st.shed if st else 0,
                    "pool_limit": share.get("pool_limit", 0),
                    "conveyor_workers": share.get(
                        "conveyor_workers", 0),
                    "resident_bytes": share.get("resident_bytes", 0),
                }
        return out
