"""Mediator: plan-step fan-out to per-node time caches.

Mirror of the reference's mediator + time-cast pair (SURVEY §2.5
mediator row; ydb/core/tx/mediator, time_cast.cpp): the coordinator
plans steps, the MEDIATOR fans completed steps out to subscribers, and
each node keeps a local TIME CACHE so readers learn the current
consistent snapshot without a coordinator round trip. The fan-out is
an in-process callback (``Coordinator.subscribe_completed``).

The port's own copy of ``ydb_tpu/tx/mediator.py``; it leaves nothing
out. The reference's docstring says that across processes the
subscription rides the interconnect (a callback that sends a step
message), but the reference has no code for it, and the port adds
none.
"""

from __future__ import annotations

import threading


class NodeTimeCache:
    """Per-node view of mediator time (TMediatorTimecastEntry analog):
    ``read_snapshot`` is a local read; ``wait_for`` blocks until the
    barrier passes a step (the 'wait until my tx is visible' path)."""

    def __init__(self):
        self._step = 0
        self._cv = threading.Condition()

    def advance(self, step: int) -> None:
        with self._cv:
            if step > self._step:
                self._step = step
                self._cv.notify_all()

    def read_snapshot(self) -> int:
        with self._cv:
            return self._step

    def wait_for(self, step: int, timeout: float = 10.0) -> int:
        with self._cv:
            if not self._cv.wait_for(lambda: self._step >= step,
                                     timeout=timeout):
                raise TimeoutError(
                    f"mediator time stuck below step {step}")
            return self._step


class Mediator:
    """Fans coordinator barrier advances to registered time caches."""

    def __init__(self, coordinator):
        self.coordinator = coordinator
        self._caches: list[NodeTimeCache] = []
        coordinator.subscribe_completed(self._fan_out)

    def register(self) -> NodeTimeCache:
        cache = NodeTimeCache()
        # append FIRST, then seed: a barrier advance in between reaches
        # the cache via fan-out, and advance() is monotonic either way —
        # the reverse order could strand a late joiner one step behind
        self._caches.append(cache)
        cache.advance(self.coordinator.read_snapshot())
        return cache

    def _fan_out(self, step: int) -> None:
        for cache in self._caches:
            cache.advance(step)
