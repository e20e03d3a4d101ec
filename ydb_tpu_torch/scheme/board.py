"""Scheme board: eventually-consistent pub/sub of path descriptions.

Mirror of the reference's scheme board (populator.h -> replica.h ->
subscriber.h, per-node cache tx/scheme_cache/; SURVEY.md §2.5): the
SchemeShard (populator) pushes every path description change to a set of
replica actors; per-node SchemeCache actors subscribe to a replica and
keep the latest-version description of each path, so query compilation
resolves tables without a round trip to the schema tablet. Versions make
the propagation idempotent and order-insensitive: a replica or cache
only applies a strictly newer version (or a deletion at version 0 that
outruns a stale update).

The port's own copy of ``ydb_tpu/scheme/board.py``.
"""

from __future__ import annotations

import dataclasses

from ydb_tpu_torch.runtime.actors import Actor, ActorId


@dataclasses.dataclass
class BoardPublish:
    path: str
    desc: dict | None     # None = deleted
    version: int


@dataclasses.dataclass
class BoardSubscribe:
    pass


@dataclasses.dataclass
class BoardSnapshot:
    entries: dict  # path -> (desc, version)


class SchemeBoardReplica(Actor):
    def __init__(self):
        super().__init__()
        self.entries: dict[str, tuple[dict | None, int]] = {}
        self.subscribers: list[ActorId] = []

    def _apply(self, message: BoardPublish) -> bool:
        # versions are globally monotonic scheme-op ids (deletes carry
        # one too), so plain newest-wins is order-insensitive even
        # across delete + re-create of the same path
        cur = self.entries.get(message.path)
        if cur is not None and message.version <= cur[1]:
            return False
        self.entries[message.path] = (message.desc, message.version)
        return True

    def receive(self, message, sender):
        if isinstance(message, BoardPublish):
            if self._apply(message):
                for sub in self.subscribers:
                    self.send(sub, message)
        elif isinstance(message, BoardSubscribe):
            self.subscribers.append(sender)
            self.send(sender, BoardSnapshot(dict(self.entries)))


class SchemeCache(Actor):
    """Per-node cache (tx/scheme_cache analog): resolve() is the sync
    read used by compilation on that node."""

    def __init__(self, replica: ActorId):
        super().__init__()
        self.replica = replica
        self.entries: dict[str, tuple[dict | None, int]] = {}

    def on_start(self):
        self.send(self.replica, BoardSubscribe())

    def receive(self, message, sender):
        if isinstance(message, BoardSnapshot):
            for path, (desc, ver) in message.entries.items():
                self._apply(BoardPublish(path, desc, ver))
        elif isinstance(message, BoardPublish):
            self._apply(message)

    def _apply(self, message: BoardPublish):
        cur = self.entries.get(message.path)
        if cur is not None and message.version <= cur[1]:
            return
        self.entries[message.path] = (message.desc, message.version)

    def resolve(self, path: str) -> dict | None:
        cur = self.entries.get(path)
        return cur[0] if cur else None
