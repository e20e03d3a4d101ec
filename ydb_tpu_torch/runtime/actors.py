"""Host control-plane actor runtime.

The port's own copy of ``ydb_tpu/runtime/actors.py``. The reference
builds everything on a C++ actor system: mailboxes, location
transparency, timers (IActor actor.h:345, TActorSystem actorsystem.h:133;
SURVEY.md §2.2). Device work runs inside the actors; this module is the
*control* plane: a small, dependency-free actor layer, used here by the
DQ compute actors.

Design choices:
  * cooperative single-threaded scheduling (an explicit run loop, not
    asyncio): messages deliver in deterministic FIFO order per mailbox,
    which makes the simulated test runtime (§4 tier 2) and the production
    runtime THE SAME code — tests swap the clock and add interceptors
    rather than using a different engine
  * location transparency: ActorId carries a node id; cross-node sends go
    through a pluggable transport (``SimRuntime``'s in-process routing
    here), invisible to the sender
  * timers ride the same queue via a schedule heap against the runtime's
    clock — virtual in tests (AdvanceCurrentTime analog,
    testlib/test_runtime.h:258)
"""

from __future__ import annotations

import dataclasses
import heapq
import itertools
import time
from collections import deque
from typing import Any, Callable


@dataclasses.dataclass(frozen=True)
class ActorId:
    node: int
    local: int

    def __str__(self):
        return f"[{self.node}:{self.local}]"


@dataclasses.dataclass
class Envelope:
    target: ActorId
    sender: ActorId | None
    message: Any
    seq: int = 0


class Actor:
    """Base actor: override receive(). Lifecycle: registered -> receive()
    per message -> passivated via system.stop()."""

    def __init__(self):
        self.system: "ActorSystem" = None  # set on register
        self.self_id: ActorId = None

    def on_start(self) -> None:
        pass

    def receive(self, message: Any, sender: ActorId | None) -> None:
        raise NotImplementedError

    # convenience
    def send(self, target: ActorId, message: Any) -> None:
        self.system.send(target, message, sender=self.self_id)

    def schedule(self, delay: float, message: Any) -> None:
        self.system.schedule(delay, self.self_id, message,
                             sender=self.self_id)


class ActorSystem:
    """One 'node' worth of actors with a deterministic run loop.

    ``interceptor``: optional fn(Envelope) -> bool; return False to drop
    the message (the event-observer hook the reference's TTestActorRuntime
    uses for race/failure interleaving tests, test_runtime.h:220).
    ``clock``: fn() -> float; tests install a virtual clock.
    """

    def __init__(self, node: int = 1, clock: Callable[[], float] | None = None):
        self.node = node
        self._actors: dict[int, Actor] = {}
        self._next_local = itertools.count(1)
        self._queue: deque[Envelope] = deque()
        self._timers: list = []  # (fire_at, seq, Envelope)
        self._seq = itertools.count()
        self._clock = clock or time.monotonic
        self.interceptor: Callable[[Envelope], bool] | None = None
        self._remote_send: Callable[[Envelope], None] | None = None
        self.dead_letters: list[Envelope] = []

    # ---- registration ----

    def register(self, actor: Actor) -> ActorId:
        aid = ActorId(self.node, next(self._next_local))
        actor.system = self
        actor.self_id = aid
        self._actors[aid.local] = actor
        actor.on_start()
        return aid

    def stop(self, aid: ActorId) -> None:
        self._actors.pop(aid.local, None)

    def actor(self, aid: ActorId) -> Actor | None:
        return self._actors.get(aid.local)

    # ---- messaging ----

    def send(self, target: ActorId, message: Any,
             sender: ActorId | None = None) -> None:
        env = Envelope(target, sender, message, next(self._seq))
        if target.node != self.node:
            if self._remote_send is None:
                self.dead_letters.append(env)
                return
            self._remote_send(env)
            return
        self._queue.append(env)

    def set_remote_transport(self, fn: Callable[[Envelope], None]) -> None:
        self._remote_send = fn

    def inject(self, env: Envelope) -> None:
        """Entry point for messages arriving from another node."""
        self._queue.append(env)

    def schedule(self, delay: float, target: ActorId, message: Any,
                 sender: ActorId | None = None) -> None:
        env = Envelope(target, sender, message, next(self._seq))
        heapq.heappush(self._timers, (self._clock() + delay, env.seq, env))

    # ---- run loop ----

    def _fire_due_timers(self) -> None:
        now = self._clock()
        while self._timers and self._timers[0][0] <= now:
            _, _, env = heapq.heappop(self._timers)
            self._queue.append(env)

    def step(self) -> bool:
        """Deliver one message. Returns False when idle."""
        self._fire_due_timers()
        if not self._queue:
            return False
        env = self._queue.popleft()
        if self.interceptor is not None and not self.interceptor(env):
            return True  # intercepted/dropped
        actor = self._actors.get(env.target.local)
        if actor is None:
            self.dead_letters.append(env)
            return True
        actor.receive(env.message, env.sender)
        return True

    def run(self, max_steps: int = 1_000_000) -> int:
        """Drain until idle (all mailboxes empty, no due timers)."""
        steps = 0
        while steps < max_steps and self.step():
            steps += 1
        return steps

    def pending(self) -> int:
        return len(self._queue)

    def has_timers(self) -> bool:
        return bool(self._timers)

    def next_timer_at(self) -> float | None:
        return self._timers[0][0] if self._timers else None
