"""Executor pools: a multi-threaded actor runtime.

Reference: the actor system schedules mailboxes over named executor
pools of worker threads (System/User/IC/Batch pools, actorsystem.h:133;
harmonizer balancing — SURVEY §2.2 executor-pools row). The TPU build's
cooperative single-thread ActorSystem stays THE deterministic core (sim
tests == prod code); this module composes several of them into a
process-wide pooled runtime:

  * each pool is one ActorSystem driven by its own worker thread —
    actors in a pool stay single-threaded (mailbox FIFO preserved),
    pools run in parallel (blob IO / background / API separation)
  * cross-pool sends are location-transparent: ActorId.node identifies
    the pool; the remote-transport hook injects into the target pool's
    queue (GIL-atomic deque append, same contract the TCP interconnect
    relies on)
  * ``stats()`` is the harmonizer's observable: per-pool queue depths
    and delivered counts for rebalancing decisions

The port's own copy of ``ydb_tpu/runtime/pools.py``.
"""

from __future__ import annotations

import threading
import time

from ydb_tpu_torch.runtime.actors import Actor, ActorId, ActorSystem


class ThreadedPools:
    """N executor pools, each an ActorSystem on its own thread."""

    def __init__(self, n_pools: int = 2, idle_sleep: float = 0.002):
        self.pools = [ActorSystem(node=i + 1) for i in range(n_pools)]
        self.idle_sleep = idle_sleep
        self._delivered = [0] * n_pools
        self._busy = [False] * n_pools  # inside run(): handler in flight
        self._stop = threading.Event()
        for sys_ in self.pools:
            sys_.set_remote_transport(self._route)
        self._threads = [
            threading.Thread(target=self._drive, args=(i,), daemon=True)
            for i in range(n_pools)
        ]

    # -- wiring --

    def _route(self, env) -> None:
        pool = env.target.node - 1
        if not (0 <= pool < len(self.pools)):
            self.pools[0].dead_letters.append(env)
            return
        self.pools[pool].inject(env)

    def register(self, actor: Actor, pool: int = 0) -> ActorId:
        return self.pools[pool].register(actor)

    def send(self, target: ActorId, message, sender=None) -> None:
        self._route_from(target, message, sender)

    def _route_from(self, target, message, sender) -> None:
        # enter through any pool's send so remote routing applies
        self.pools[0].send(target, message, sender=sender)

    # -- lifecycle --

    def start(self) -> None:
        for t in self._threads:
            t.start()

    def _drive(self, i: int) -> None:
        sys_ = self.pools[i]
        while not self._stop.is_set():
            self._busy[i] = True
            steps = sys_.run()
            self._busy[i] = False
            self._delivered[i] += steps
            if steps == 0:
                time.sleep(self.idle_sleep)

    def _all_idle(self) -> bool:
        # pending counts queued envelopes; busy covers a handler that
        # popped the last one and may still produce sends
        return all(p.pending() == 0 for p in self.pools) and not any(
            self._busy)

    def drain(self, timeout: float = 10.0) -> None:
        """Block until every pool is idle (tests/shutdown barriers)."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if self._all_idle():
                # double-check after a beat: a cross-pool send may be
                # mid-flight between queues
                time.sleep(self.idle_sleep * 2)
                if self._all_idle():
                    return
            time.sleep(self.idle_sleep)
        raise TimeoutError("pools busy")

    def stop(self) -> None:
        self._stop.set()
        for t in self._threads:
            if t.is_alive():
                t.join(timeout=5)

    def stats(self) -> list[dict]:
        """Per-pool load view (the harmonizer's input)."""
        return [
            {"pool": i + 1, "queued": p.pending(),
             "delivered": self._delivered[i]}
            for i, p in enumerate(self.pools)
        ]
