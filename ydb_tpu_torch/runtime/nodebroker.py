"""NodeBroker: dynamic node registration + TenantPool slots.

Mirror of the reference's dynamic-node plane (ydb/core/mind/
node_broker.cpp: dynamic node ids leased with expiry, resolved by the
rest of the cluster; mind/tenant_pool.cpp: per-node slots offered to
tenants; mind/local.cpp registers the node with Hive — our LocalAgent
in tablet/hive.py already plays that part; SURVEY.md §2.5 row
"NodeBroker / Local / TenantPool").

The broker is a durable tablet: node registrations survive broker
reboot, so a restarted broker still resolves every live node. Dynamic
ids are leased: a node must extend its lease or it expires and the id
returns to the free pool (epoch-bumped so stale resolutions are
detectable). Re-registration from the same host:port inside the lease
keeps the same id — the restart-friendly contract.

The port's own copy of ``ydb_tpu/runtime/nodebroker.py``: the same
tablet (``nodebroker``), tables and rows, so a node table written by
either package reboots in the other.
"""

from __future__ import annotations

import dataclasses
import time

from ydb_tpu_torch.engine.blobs import BlobStore
from ydb_tpu_torch.tablet.executor import TabletExecutor


@dataclasses.dataclass(frozen=True)
class NodeInfo:
    node_id: int
    host: str
    port: int
    tenant: str
    lease_deadline: float
    epoch: int


class NodeBroker:
    """Leased dynamic node ids over a durable tablet."""

    def __init__(self, store: BlobStore, dynamic_id_base: int = 1024,
                 lease_s: float = 60.0, now=time.time):
        self.executor = TabletExecutor.boot("nodebroker", store)
        self.base = dynamic_id_base
        self.lease_s = lease_s
        self.now = now

    def _epoch(self) -> int:
        row = self.executor.db.table("meta").get(("epoch",))
        return row["v"] if row else 1

    def register(self, host: str, port: int,
                 tenant: str = "/Root") -> NodeInfo:
        """Assign (or renew) a dynamic node id for host:port."""
        def fn(txc):
            epoch = self._epoch()
            deadline = self.now() + self.lease_s
            used = set()
            for (nid,), row in self.executor.db.table("nodes").range():
                if row["host"] == host and row["port"] == port:
                    txc.put("nodes", (nid,), dict(
                        row, deadline=deadline, tenant=tenant))
                    return NodeInfo(nid, host, port, tenant, deadline,
                                    epoch)
                used.add(nid)
            nid = self.base
            while nid in used:
                nid += 1
            txc.put("nodes", (nid,), {
                "host": host, "port": port, "tenant": tenant,
                "deadline": deadline,
            })
            return NodeInfo(nid, host, port, tenant, deadline, epoch)
        return self.executor.run(fn)

    def extend(self, node_id: int) -> float:
        def fn(txc):
            row = txc.get("nodes", (node_id,))
            if row is None:
                raise KeyError(f"no node {node_id}")
            deadline = self.now() + self.lease_s
            txc.put("nodes", (node_id,), dict(row, deadline=deadline))
            return deadline
        return self.executor.run(fn)

    def tick(self, now: float | None = None) -> list[int]:
        """Expire lapsed leases; returns the node ids that went away.
        Any expiry bumps the epoch (stale-resolution fencing)."""
        now = self.now() if now is None else now

        def fn(txc):
            dead = [nid for (nid,), row in
                    self.executor.db.table("nodes").range()
                    if row["deadline"] < now]
            for nid in dead:
                txc.erase("nodes", (nid,))
            if dead:
                txc.put("meta", ("epoch",), {"v": self._epoch() + 1})
            return dead
        return self.executor.run(fn)

    def nodes(self) -> list[NodeInfo]:
        epoch = self._epoch()
        return [
            NodeInfo(nid, row["host"], row["port"], row["tenant"],
                     row["deadline"], epoch)
            for (nid,), row in self.executor.db.table("nodes").range()
        ]

    def resolve(self, node_id: int) -> tuple[str, int]:
        row = self.executor.db.table("nodes").get((node_id,))
        if row is None:
            raise KeyError(f"no node {node_id}")
        return row["host"], row["port"]

    def connect_peers(self, interconnect) -> None:
        """Feed the live node table into an Interconnect's peer map
        (dynamic discovery replacing static add_peer wiring)."""
        for info in self.nodes():
            if info.node_id != interconnect.system.node:
                interconnect.add_peer(info.node_id, info.host,
                                      info.port)


class TenantPool:
    """Per-node compute slots offered to tenants (tenant_pool.cpp
    analog): a fixed slot budget; tenants claim/release slots; the
    assignment drives which tenants' tablets this node may host."""

    def __init__(self, slots: int = 4):
        self.slots = slots
        self.assigned: dict[str, int] = {}

    def free_slots(self) -> int:
        return self.slots - sum(self.assigned.values())

    def claim(self, tenant: str, count: int = 1) -> bool:
        if self.free_slots() < count:
            return False
        self.assigned[tenant] = self.assigned.get(tenant, 0) + count
        return True

    def release(self, tenant: str, count: int | None = None) -> None:
        have = self.assigned.get(tenant, 0)
        drop = have if count is None else min(count, have)
        if have - drop <= 0:
            self.assigned.pop(tenant, None)
        else:
            self.assigned[tenant] = have - drop

    def tenants(self) -> dict[str, int]:
        return dict(self.assigned)
