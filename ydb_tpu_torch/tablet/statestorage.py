"""State storage: replicated registry of tablet leaders.

Mirror of the reference's StateStorage (core/base/statestorage.cpp,
statestorage_proxy.cpp; SURVEY.md §2.4): a quorum ring of replica actors
holding (tablet_id -> leader actor, generation) in memory only — the
truth about *who currently leads* a tablet lives here, while the truth
about the tablet's *state* lives in the blob store. Updates carry the
boot generation; a replica accepts only non-decreasing generations, so a
zombie leader can never overwrite its successor's registration. Lookups
read a majority and take the max-generation answer.

The port's own copy of ``ydb_tpu/tablet/statestorage.py``: the same
messages, majority and generation fencing.
"""

from __future__ import annotations

import dataclasses
from typing import Any

from ydb_tpu_torch.runtime.actors import Actor, ActorId


@dataclasses.dataclass
class SSUpdate:
    tablet_id: str
    leader: ActorId
    generation: int
    cookie: Any = None


@dataclasses.dataclass
class SSUpdateAck:
    tablet_id: str
    accepted: bool
    cookie: Any = None


@dataclasses.dataclass
class SSLookup:
    tablet_id: str
    cookie: Any = None


@dataclasses.dataclass
class SSLookupReply:
    tablet_id: str
    leader: ActorId | None
    generation: int
    cookie: Any = None


@dataclasses.dataclass
class SSDelete:
    tablet_id: str


class StateStorageReplica(Actor):
    def __init__(self):
        super().__init__()
        self.entries: dict[str, tuple[ActorId, int]] = {}

    def receive(self, message, sender):
        if isinstance(message, SSUpdate):
            cur = self.entries.get(message.tablet_id)
            accepted = cur is None or message.generation >= cur[1]
            if accepted:
                self.entries[message.tablet_id] = (
                    message.leader, message.generation)
            self.send(sender, SSUpdateAck(
                message.tablet_id, accepted, message.cookie))
        elif isinstance(message, SSLookup):
            cur = self.entries.get(message.tablet_id)
            leader, gen = (cur if cur else (None, 0))
            self.send(sender, SSLookupReply(
                message.tablet_id, leader, gen, message.cookie))
        elif isinstance(message, SSDelete):
            self.entries.pop(message.tablet_id, None)


class StateStorageProxy(Actor):
    """Per-node proxy: fans requests to all replicas, answers the caller
    once a majority agrees (statestorage_proxy.cpp shape).

    Client protocol: send SSUpdate/SSLookup to the proxy; it replies with
    SSUpdateAck / SSLookupReply (max-generation winner).
    """

    def __init__(self, replicas: list[ActorId]):
        super().__init__()
        self.replicas = list(replicas)
        self._pending: dict[int, dict] = {}
        self._next_req = 0

    def _majority(self) -> int:
        return len(self.replicas) // 2 + 1

    def receive(self, message, sender):
        if isinstance(message, (SSUpdate, SSLookup)):
            req_id = self._next_req
            self._next_req += 1
            self._pending[req_id] = {
                "caller": sender, "message": message, "replies": [],
                "done": False,
            }
            inner = dataclasses.replace(message, cookie=(req_id,
                                                         message.cookie))
            for rep in self.replicas:
                self.send(rep, inner)
        elif isinstance(message, SSDelete):
            for rep in self.replicas:
                self.send(rep, message)
        elif isinstance(message, (SSUpdateAck, SSLookupReply)):
            req_id, orig_cookie = message.cookie
            st = self._pending.get(req_id)
            if st is None or st["done"]:
                return
            st["replies"].append(message)
            if len(st["replies"]) >= self._majority():
                st["done"] = True
                if isinstance(message, SSUpdateAck):
                    ok = all(r.accepted for r in st["replies"])
                    self.send(st["caller"], SSUpdateAck(
                        message.tablet_id, ok, orig_cookie))
                else:
                    best = max(st["replies"], key=lambda r: r.generation)
                    self.send(st["caller"], SSLookupReply(
                        message.tablet_id, best.leader, best.generation,
                        orig_cookie))
