"""Hive: tablet placement, boot and failure recovery.

Mirror of the reference's Hive tablet + per-node Local agent
(THive mind/hive/hive_impl.h:158; mind/local.cpp; SURVEY.md §2.5, §5.3):
Hive knows every registered node (via its Local agent), decides which
node hosts each tablet (least-loaded placement, hive/balancer.cpp
analog), and — the failure-recovery half — pings agents and reboots a
dead node's tablets elsewhere. Because a tablet's durable state is
snapshot+redo in the blob store (ydb_tpu_torch.tablet.executor), a reboot on a
new node recovers full state; state storage registration with a higher
generation fences the old leader.

The per-node LocalAgent hosts the actual TabletActor instances; tablet
behavior is supplied by a factory registry: type name -> f(tablet_id,
executor) -> TabletActor.

The port's own copy of ``ydb_tpu/tablet/hive.py``: the same messages,
placement and ping schedule (``PING_PERIOD``, ``DEAD_AFTER_MISSED``,
which an instance may set for a faster clock).
"""

from __future__ import annotations

import dataclasses
from typing import Callable

from ydb_tpu_torch.engine.blobs import BlobStore
from ydb_tpu_torch.runtime.actors import Actor, ActorId
from ydb_tpu_torch.tablet.executor import TabletExecutor
from ydb_tpu_torch.tablet.statestorage import SSUpdate, SSUpdateAck


# ---- messages ----

@dataclasses.dataclass
class RegisterNode:
    node: int


@dataclasses.dataclass
class CreateTablet:
    tablet_id: str
    tablet_type: str


@dataclasses.dataclass
class TabletCreated:
    tablet_id: str
    node: int


@dataclasses.dataclass
class BootTablet:
    tablet_id: str
    tablet_type: str


@dataclasses.dataclass
class TabletBooted:
    tablet_id: str
    actor: ActorId
    generation: int


@dataclasses.dataclass
class StopTablet:
    tablet_id: str


@dataclasses.dataclass
class Ping:
    pass


@dataclasses.dataclass
class Pong:
    node: int


@dataclasses.dataclass
class KillNode:
    """Test/nemesis hook: agent drops all its tablets and goes silent."""
    pass


class TabletActor(Actor):
    """Base for tablet impls: owns the executor; subclasses override
    handle() for app messages. Pipe traffic arrives pre-deduplicated."""

    def __init__(self, tablet_id: str, executor: TabletExecutor):
        super().__init__()
        self.tablet_id = tablet_id
        self.executor = executor
        self._pipe_seen: dict[int, int] = {}  # pipe_id -> last seq

    def receive(self, message, sender):
        from ydb_tpu_torch.tablet.pipe import PipeAck, PipeRequest

        if isinstance(message, PipeRequest):
            last = self._pipe_seen.get(message.pipe_id, -1)
            self.send(sender, PipeAck(message.pipe_id, message.seq))
            if message.seq <= last:
                return  # duplicate retransmit
            self._pipe_seen[message.pipe_id] = message.seq
            self.handle(message.payload, message.reply_to)
        else:
            self.handle(message, sender)

    def handle(self, message, reply_to):
        raise NotImplementedError


class LocalAgent(Actor):
    """Per-node tablet host (mind/local.cpp analog)."""

    def __init__(self, store: BlobStore, ss_proxy: ActorId,
                 factories: dict[str, Callable], hive: ActorId | None = None):
        super().__init__()
        self.store = store
        self.ss_proxy = ss_proxy
        self.factories = factories
        self.hive = hive
        self.tablets: dict[str, ActorId] = {}
        self.dead = False

    def on_start(self):
        if self.hive is not None:
            self.send(self.hive, RegisterNode(self.self_id.node))

    def receive(self, message, sender):
        if self.dead:
            return
        if isinstance(message, BootTablet):
            executor = TabletExecutor.boot(message.tablet_id, self.store)
            actor = self.factories[message.tablet_type](
                message.tablet_id, executor)
            aid = self.system.register(actor)
            self.tablets[message.tablet_id] = aid
            # publish leadership; generation fences older leaders
            self.send(self.ss_proxy, SSUpdate(
                message.tablet_id, aid, executor.generation))
            self.send(sender, TabletBooted(
                message.tablet_id, aid, executor.generation))
        elif isinstance(message, SSUpdateAck):
            pass
        elif isinstance(message, StopTablet):
            aid = self.tablets.pop(message.tablet_id, None)
            if aid is not None:
                self.system.stop(aid)
        elif isinstance(message, Ping):
            self.send(sender, Pong(self.self_id.node))
        elif isinstance(message, KillNode):
            for aid in self.tablets.values():
                self.system.stop(aid)
            self.tablets.clear()
            self.dead = True


class Hive(Actor):
    PING_PERIOD = 5.0
    DEAD_AFTER_MISSED = 2

    def __init__(self):
        super().__init__()
        self.agents: dict[int, ActorId] = {}
        self.missed: dict[int, int] = {}
        self.tablets: dict[str, dict] = {}  # id -> {type, node, booted}
        self._ping_started = False

    def _load(self, node: int) -> int:
        return sum(1 for t in self.tablets.values() if t["node"] == node)

    def _pick_node(self, exclude: set[int] = frozenset()) -> int | None:
        alive = [n for n in self.agents if n not in exclude]
        if not alive:
            return None
        return min(alive, key=lambda n: (self._load(n), n))

    def _boot_on(self, tablet_id: str, node: int) -> None:
        info = self.tablets[tablet_id]
        info["node"] = node
        info["booted"] = False
        self.send(self.agents[node],
                  BootTablet(tablet_id, info["type"]))

    def receive(self, message, sender):
        if isinstance(message, RegisterNode):
            self.agents[message.node] = sender
            self.missed[message.node] = 0
            if not self._ping_started:
                self._ping_started = True
                self.schedule(self.PING_PERIOD, Ping())
        elif isinstance(message, CreateTablet):
            node = self._pick_node()
            self.tablets[message.tablet_id] = {
                "type": message.tablet_type, "node": node,
                "booted": False, "requester": sender,
            }
            if node is not None:
                self._boot_on(message.tablet_id, node)
        elif isinstance(message, TabletBooted):
            info = self.tablets.get(message.tablet_id)
            if info is not None:
                info["booted"] = True
                req = info.pop("requester", None)
                if req is not None:
                    self.send(req, TabletCreated(
                        message.tablet_id, info["node"]))
        elif isinstance(message, Ping):
            # self-scheduled tick: ping every agent, count misses
            for node, aid in list(self.agents.items()):
                self.missed[node] = self.missed.get(node, 0) + 1
                if self.missed[node] > self.DEAD_AFTER_MISSED:
                    self._on_node_dead(node)
                else:
                    self.send(aid, Ping())
            self.schedule(self.PING_PERIOD, Ping())
        elif isinstance(message, Pong):
            self.missed[message.node] = 0

    def _on_node_dead(self, node: int) -> None:
        self.agents.pop(node, None)
        self.missed.pop(node, None)
        for tablet_id, info in self.tablets.items():
            if info["node"] == node:
                new_node = self._pick_node(exclude={node})
                if new_node is not None:
                    self._boot_on(tablet_id, new_node)
