"""BlobStorage controller: node warden registry + automated self-heal.

Mirror of the reference's NodeWarden + BSController pair (SURVEY §2.3
NodeWarden/BSC row; ydb/core/blobstorage/nodewarden,
mind/bscontroller/self_heal.cpp): each node's warden registers the
PDisks it hosts; the controller owns the group map, watches disk
health, and when a group runs degraded it picks a spare from the warden
inventory, swaps it into the broken slot and drives the rebuild —
without operator involvement. The DSProxy's manual ``self_heal`` stays
the mechanism; the controller supplies the policy loop.

The port's own copy of ``ydb_tpu/blobstorage/controller.py``.
"""

from __future__ import annotations

import dataclasses

from ydb_tpu_torch.blobstorage.group import DSProxy, VDisk


@dataclasses.dataclass
class HealRecord:
    group_id: int
    slot: int
    old_disk: str
    new_disk: str
    parts_rebuilt: int


class NodeWarden:
    """Per-node disk inventory (nodewarden analog): spares register
    here; the controller draws replacements from the pool."""

    def __init__(self, node_id: int):
        self.node_id = node_id
        self._spares: list[VDisk] = []

    def register_spare(self, disk: VDisk) -> None:
        self._spares.append(disk)

    def take_spare(self) -> VDisk | None:
        return self._spares.pop(0) if self._spares else None

    @property
    def spare_count(self) -> int:
        return len(self._spares)


class BSController:
    """Group map + the self-heal policy loop (bscontroller analog)."""

    def __init__(self):
        self.proxies: dict[int, DSProxy] = {}
        self.wardens: dict[int, NodeWarden] = {}
        self.heal_log: list[HealRecord] = []

    def register_group(self, proxy: DSProxy) -> None:
        self.proxies[proxy.group.group_id] = proxy

    def register_warden(self, warden: NodeWarden) -> None:
        self.wardens[warden.node_id] = warden

    def _next_spare(self) -> VDisk | None:
        wardens = sorted(self.wardens.values(),
                         key=lambda w: -w.spare_count)
        for w in wardens:
            d = w.take_spare()
            if d is not None:
                return d
        return None

    def degraded_groups(self) -> list[tuple[int, list[int]]]:
        """(group_id, [down slots]) for every group with dead disks."""
        out = []
        for gid, proxy in sorted(self.proxies.items()):
            down = [i for i, d in enumerate(proxy.group.disks) if d.down]
            if down:
                out.append((gid, down))
        return out

    def check_and_heal(self) -> list[HealRecord]:
        """One policy pass: every down slot heals onto a spare while
        spares last (worst-degraded groups first — a group past its
        loss tolerance is prioritized the way the reference orders its
        self-heal queue)."""
        degraded = sorted(self.degraded_groups(),
                          key=lambda g: -len(g[1]))
        healed: list[HealRecord] = []
        for gid, slots in degraded:
            proxy = self.proxies[gid]
            for slot in slots:
                spare = self._next_spare()
                if spare is None:
                    return healed  # out of spares: remaining stay down
                old = proxy.group.disks[slot]
                rebuilt = proxy.self_heal(slot, spare)
                rec = HealRecord(gid, slot, old.disk_id, spare.disk_id,
                                 rebuilt)
                self.heal_log.append(rec)
                healed.append(rec)
        return healed
