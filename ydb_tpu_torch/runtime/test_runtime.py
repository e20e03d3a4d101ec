"""Deterministic multi-node simulated runtime (the tier-2 test workhorse).

Mirror of the reference's TTestActorRuntime (testlib/test_runtime.h:206;
SURVEY.md §4 tier 2): N virtual nodes in one process, a virtual clock
(AdvanceCurrentTime :258), deterministic dispatch (DispatchEvents :280)
and message observers/interceptors (:220) for dropping, reordering and
delaying messages — how multi-node behavior, races and failure
interleavings are tested without a cluster.

Production and simulated runtimes share ActorSystem; this adds the
multi-node weave, virtual time, and observation points.
"""

from __future__ import annotations

from typing import Callable

from ydb_tpu_torch.runtime.actors import ActorSystem, Envelope


class SimRuntime:
    def __init__(self, n_nodes: int = 1):
        self.now = 0.0
        self.nodes: dict[int, ActorSystem] = {}
        self.observer: Callable[[Envelope], str] | None = None
        self.delivery_log: list[Envelope] = []
        for n in range(1, n_nodes + 1):
            sys = ActorSystem(node=n, clock=lambda: self.now)
            sys.set_remote_transport(self._route)
            sys.interceptor = self._intercept
            self.nodes[n] = sys

    def system(self, node: int) -> ActorSystem:
        return self.nodes[node]

    # ---- cross-node routing (interconnect stand-in) ----

    def _route(self, env: Envelope) -> None:
        target_sys = self.nodes.get(env.target.node)
        if target_sys is None:
            return
        target_sys.inject(env)

    def _intercept(self, env: Envelope) -> bool:
        if self.observer is not None:
            verdict = self.observer(env)
            if verdict == "drop":
                return False
            # "pass" or anything else delivers
        self.delivery_log.append(env)
        return True

    # ---- deterministic dispatch ----

    def dispatch(self, max_steps: int = 1_000_000) -> int:
        """Round-robin nodes until every mailbox is idle."""
        total = 0
        progressed = True
        while progressed and total < max_steps:
            progressed = False
            for sys in self.nodes.values():
                if sys.step():
                    progressed = True
                    total += 1
        return total

    def advance_time(self, seconds: float) -> None:
        """Virtual clock jump; due timers fire on next dispatch."""
        self.now += seconds

    def run_until(self, cond: Callable[[], bool],
                  max_iterations: int = 1000) -> bool:
        """Dispatch + auto-advance time to the next timer until cond()."""
        for _ in range(max_iterations):
            self.dispatch()
            if cond():
                return True
            nxt = None
            for sys in self.nodes.values():
                t = sys.next_timer_at()
                if t is not None and (nxt is None or t < nxt):
                    nxt = t
            if nxt is None:
                return cond()
            self.now = max(self.now, nxt)
        return cond()
