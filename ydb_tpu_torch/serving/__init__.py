"""serving/ — the multi-tenant front door.

The admission/tenancy plane between the protocol fronts (api/pgwire.py;
the reference's gRPC front comes later) and the kqp session layer:
tenant registry + weighted workload pools (tenants.py) and the
cross-client admission queue with per-tenant shedding and
deadline-ordered waits (admission.py).

Usage::

    reg = serving.TenantRegistry()
    reg.register("gold", weight=3.0, max_inflight=32)
    reg.register("bronze", weight=1.0, max_inflight=8)
    serving.install(cluster, reg)       # cluster.front_door set

Fronts resolve a connection's tenant with :func:`resolve_tenant` and
decide whether a statement may run outside their connection-serial
lock with :func:`is_read_statement` — read statements from different
connections must overlap so the batch window (kqp/batch.py) sees the
full cross-client queue.

The port's own copy of ``ydb_tpu/serving/__init__.py``.
"""

from __future__ import annotations

from ydb_tpu_torch.serving.admission import FrontDoor, Seat  # noqa: F401
from ydb_tpu_torch.serving.tenants import (  # noqa: F401
    DEFAULT_TENANT,
    Tenant,
    TenantRegistry,
)

#: statement heads that never mutate state: safe to execute without the
#: protocol front's global write lock (so concurrent connections can
#: co-occupy the cross-query batch window)
_READ_HEADS = ("SELECT", "EXPLAIN", "SHOW", "VALUES")


def install(cluster, registry: TenantRegistry | None = None) -> FrontDoor:
    """Attach a :class:`FrontDoor` to the cluster (idempotent per
    cluster: a second install replaces the first)."""
    return FrontDoor(cluster, registry).install()


def is_read_statement(sql: str) -> bool:
    """True when the statement is read-only by its leading keyword
    (comments skipped). Fronts keep DDL/DML/transaction statements
    under their serial lock and let reads run concurrently."""
    s = sql.lstrip()
    while s.startswith("--") or s.startswith("/*"):
        if s.startswith("--"):
            nl = s.find("\n")
            if nl < 0:
                return False
            s = s[nl + 1:].lstrip()
        else:
            end = s.find("*/")
            if end < 0:
                return False
            s = s[end + 2:].lstrip()
    head = s[:10].upper()
    return any(head.startswith(k) for k in _READ_HEADS)


def resolve_tenant(cluster, tenant: str | None = None,
                   principal: str | None = None) -> str:
    """Connection hello -> pool name through the cluster's front door
    registry; plain default-pool behavior when no front door is
    installed (the hint is still recorded so sys views label rows)."""
    fd = getattr(cluster, "front_door", None)
    if fd is not None:
        return fd.registry.resolve(tenant=tenant, principal=principal)
    return tenant or DEFAULT_TENANT
