"""Tablet pipes: reliable ordered client->tablet streams.

Mirror of the reference's pipe client (tablet/tablet_pipe_client.cpp;
SURVEY.md §2.4): a client never addresses a tablet actor directly — it
opens a pipe keyed by tablet id; the pipe resolves the current leader
through state storage, delivers messages in order, and transparently
re-resolves + retransmits when the leader dies and Hive reboots the
tablet elsewhere. Delivery is at-least-once with per-(pipe, seq) dedup
on the tablet side (TabletActor.receive), which together with in-order
retransmission gives the exactly-once-per-pipe ordering contract the
reference's pipes provide.

The port's own copy of ``ydb_tpu/tablet/pipe.py``.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Any

from ydb_tpu_torch.runtime.actors import Actor, ActorId
from ydb_tpu_torch.tablet.statestorage import SSLookup, SSLookupReply


_pipe_ids = itertools.count(1)


@dataclasses.dataclass
class PipeRequest:
    pipe_id: int
    seq: int
    payload: Any
    reply_to: ActorId  # app-level replies go here (the pipe's owner)


@dataclasses.dataclass
class PipeAck:
    pipe_id: int
    seq: int


@dataclasses.dataclass
class PipeSend:
    payload: Any


@dataclasses.dataclass
class _RetryTick:
    pass


class PipeClient(Actor):
    """Owned by one client actor; forwards its PipeSend payloads to the
    tablet's current leader with ack/retransmit."""

    RETRY_PERIOD = 2.0

    def __init__(self, tablet_id: str, ss_proxy: ActorId, owner: ActorId):
        super().__init__()
        self.tablet_id = tablet_id
        self.ss_proxy = ss_proxy
        self.owner = owner
        self.pipe_id = next(_pipe_ids)
        self.leader: ActorId | None = None
        self.leader_gen = 0
        self._seq = itertools.count()
        self._unacked: dict[int, PipeRequest] = {}
        self._resolving = False
        self._retry_armed = False

    def _resolve(self):
        if not self._resolving:
            self._resolving = True
            self.send(self.ss_proxy, SSLookup(self.tablet_id))

    def _flush(self):
        if self.leader is None:
            self._resolve()
            return
        for seq in sorted(self._unacked):
            self.send(self.leader, self._unacked[seq])
        if self._unacked and not self._retry_armed:
            self._retry_armed = True
            self.schedule(self.RETRY_PERIOD, _RetryTick())

    def receive(self, message, sender):
        if isinstance(message, PipeSend):
            req = PipeRequest(self.pipe_id, next(self._seq),
                              message.payload, self.owner)
            self._unacked[req.seq] = req
            self._flush()
        elif isinstance(message, SSLookupReply):
            self._resolving = False
            if message.leader is not None and \
                    message.generation >= self.leader_gen:
                self.leader = message.leader
                self.leader_gen = message.generation
            self._flush()
        elif isinstance(message, PipeAck):
            self._unacked.pop(message.seq, None)
        elif isinstance(message, _RetryTick):
            self._retry_armed = False
            if self._unacked:
                # leader may have moved: re-resolve, then retransmit
                self.leader = None
                self._resolve()
                self._retry_armed = True
                self.schedule(self.RETRY_PERIOD, _RetryTick())
