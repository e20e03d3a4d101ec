"""Failpoint registry: named fault-injection points.

Mirror of the reference's failure-injection plane (datashard
failpoints datashard_failpoints.h:9; the config-driven global
failure-injection actor core/util/failure_injection.cpp; PDiskFIT's
fail-injection harness; SURVEY.md §5.3): tests arm a named point with
a trigger policy and the code path under test calls ``hit(name)`` at
the instrumented spot — firing raises (or calls a custom action)
exactly where the real fault would land.

Policies: fail always, fail the Nth hit, fail N times then recover,
probabilistic (seeded — deterministic replay). Instrumented spots so
far: blob-store put/get (FailpointBlobStore wrapper usable around any
backend), and anything else can call ``failpoints.hit`` directly.

The port's own copy of ``ydb_tpu/runtime/failpoints.py``; the chaos
plane's errors (``ydb_tpu_torch/chaos``) subclass ``InjectedFault``.
"""

from __future__ import annotations

import random
import threading


class InjectedFault(Exception):
    """The armed failpoint fired."""


class _Point:
    def __init__(self, name, kind, arg, action, rng):
        self.name = name
        self.kind = kind
        self.arg = arg
        self.action = action
        self.rng = rng
        self.hits = 0
        self.fired = 0

    def should_fire(self) -> bool:
        self.hits += 1
        if self.kind == "always":
            return True
        if self.kind == "nth":
            return self.hits == self.arg
        if self.kind == "times":
            return self.fired < self.arg
        if self.kind == "prob":
            return self.rng.random() < self.arg
        raise ValueError(self.kind)


class Failpoints:
    """Process-wide registry (a fresh instance per test is cleaner)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._points: dict[str, _Point] = {}

    def arm(self, name: str, kind: str = "always", arg=None,
            action=None, seed: int = 0) -> None:
        """kind: always | nth (arg=N, 1-based) | times (arg=N) |
        prob (arg=p, seeded rng). ``action``: optional callable fired
        instead of raising InjectedFault. Misconfiguration fails HERE,
        at the arm site, not inside the instrumented production path."""
        if kind not in ("always", "nth", "times", "prob"):
            raise ValueError(f"unknown failpoint kind {kind!r}")
        if kind in ("nth", "times") and not isinstance(arg, int):
            raise ValueError(f"kind {kind!r} needs an integer arg")
        if kind == "prob" and not isinstance(arg, (int, float)):
            raise ValueError("kind 'prob' needs a probability arg")
        with self._lock:
            self._points[name] = _Point(
                name, kind, arg, action, random.Random(seed))

    def disarm(self, name: str | None = None) -> None:
        with self._lock:
            if name is None:
                self._points.clear()
            else:
                self._points.pop(name, None)

    def hit(self, name: str, **ctx) -> None:
        """Call at the instrumented spot; no-op unless armed."""
        with self._lock:
            p = self._points.get(name)
            if p is None or not p.should_fire():
                return
            p.fired += 1
            action = p.action
        if action is not None:
            action(**ctx)
        else:
            raise InjectedFault(f"failpoint {name} fired")

    def stats(self, name: str) -> dict:
        with self._lock:
            p = self._points.get(name)
            return ({"hits": p.hits, "fired": p.fired}
                    if p else {"hits": 0, "fired": 0})


#: default process-wide registry (tests may build their own)
FAILPOINTS = Failpoints()


class FailpointBlobStore:
    """BlobStore wrapper arming per-op failpoints: blob.put /
    blob.get / blob.get_range / blob.delete (PDiskFIT-style storage
    fault injection around any backend, without the backend knowing).
    The wrapped store is ``base`` — the repo's wrapper convention
    (CachedBlobStore), so one-level unwraps like ColumnShard's tier
    eviction see through this wrapper."""

    def __init__(self, base, points: Failpoints | None = None):
        self.base = base
        self.points = points if points is not None else FAILPOINTS

    def put(self, blob_id: str, data: bytes) -> None:
        self.points.hit("blob.put", blob_id=blob_id)
        self.base.put(blob_id, data)

    def get(self, blob_id: str) -> bytes:
        self.points.hit("blob.get", blob_id=blob_id)
        return self.base.get(blob_id)

    def get_range(self, blob_id: str, off: int, length: int) -> bytes:
        self.points.hit("blob.get_range", blob_id=blob_id, off=off,
                        length=length)
        return self.base.get_range(blob_id, off, length)

    def delete(self, blob_id: str) -> None:
        self.points.hit("blob.delete", blob_id=blob_id)
        self.base.delete(blob_id)

    def exists(self, blob_id: str) -> bool:
        return self.base.exists(blob_id)

    def list(self, prefix: str = "") -> list[str]:
        return self.base.list(prefix)
