"""Tenant registry: who a connection belongs to and what it is owed.

The reference models tenancy as databases served by dedicated tablet
sets with per-database resource pools (ydb/core/kqp/workload_service);
here a :class:`Tenant` is a named weight over the shared single-node
budgets — the conveyor worker pool, the ResourceBroker quota table and
the resident-store byte budget — plus the per-tenant admission caps the
front door (admission.py) enforces.

Resolution order for an incoming connection (``resolve``):

  1. an explicit ``tenant`` startup parameter / request hint,
  2. a principal binding registered via ``bind_principal`` (auth token
     identity -> tenant),
  3. the default pool, so untagged clients are always served.

Unknown tenant names resolve to ``default`` rather than erroring: a
typo'd startup parameter must not take a client's traffic down, it
just loses its reserved share.

The port's own copy of ``ydb_tpu/serving/tenants.py``.
"""

from __future__ import annotations

import dataclasses
import threading

#: the pool untagged / unknown clients land in — always registered
DEFAULT_TENANT = "default"


@dataclasses.dataclass(frozen=True)
class Tenant:
    """One workload pool's identity and entitlements.

    ``weight`` is relative: a tenant's share of each divisible budget
    is ``weight / sum(weights)``. ``max_inflight`` is the hard per-
    tenant statement cap the front door sheds past (the boundary that
    replaces the global ``Cluster.max_inflight_statements`` valve);
    ``queue_size`` bounds the deadline-ordered admission queue behind
    that cap.
    """

    name: str
    weight: float = 1.0
    max_inflight: int = 16
    queue_size: int = 64


class TenantRegistry:
    """Thread-safe tenant table + principal bindings + share math."""

    def __init__(self):
        self._lock = threading.Lock()
        self._tenants: dict[str, Tenant] = {}
        self._principals: dict[str, str] = {}
        self.register(DEFAULT_TENANT)

    def register(self, name: str, weight: float = 1.0,
                 max_inflight: int = 16,
                 queue_size: int = 64) -> Tenant:
        t = Tenant(name, float(weight), int(max_inflight),
                   int(queue_size))
        with self._lock:
            self._tenants[name] = t
        return t

    def bind_principal(self, principal: str, tenant: str) -> None:
        """Route an authenticated identity (pgwire auth_tokens user,
        gRPC token principal) to a tenant without the client having to
        tag its connections."""
        with self._lock:
            self._principals[principal] = tenant

    def get(self, name: str) -> Tenant:
        with self._lock:
            return self._tenants.get(name) \
                or self._tenants[DEFAULT_TENANT]

    def tenants(self) -> list[Tenant]:
        with self._lock:
            return list(self._tenants.values())

    def resolve(self, tenant: str | None = None,
                principal: str | None = None) -> str:
        """Connection parameters -> pool name (see module docstring)."""
        with self._lock:
            if tenant and tenant in self._tenants:
                return tenant
            if principal is not None:
                bound = self._principals.get(principal)
                if bound and bound in self._tenants:
                    return bound
            return DEFAULT_TENANT

    def shares(self, total: float) -> dict[str, int]:
        """Split an integral budget by weight: every tenant gets at
        least 1 so a tiny weight degrades to trickle, never to zero."""
        with self._lock:
            ts = list(self._tenants.values())
        wsum = sum(t.weight for t in ts) or 1.0
        return {t.name: max(1, round(total * t.weight / wsum))
                for t in ts}
