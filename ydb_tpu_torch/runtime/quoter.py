"""Quoter service: hierarchical token-bucket rate limiting.

Reference: the kesus-backed quoter service
(ydb/core/quoter/quoter_service.cpp; rate-limiter API SURVEY §2.14).
Resources form a path hierarchy ("account/queries"); each node is a
token bucket with a fill rate and burst ceiling, and a child consumes
from every bucket on its path (parent throttles the subtree).

The port's own copy of ``ydb_tpu/runtime/quoter.py``: the port's
``Cluster.quoter`` gate (``kqp/session.py``) draws one unit from
``kqp/requests`` per statement and raises ``ThrottledError``.
"""

from __future__ import annotations

import threading
import time


class _Bucket:
    def __init__(self, rate: float, burst: float):
        self.rate = rate
        self.burst = burst
        self.tokens = burst
        self.at = None  # lazily set on first use (injectable clock)

    def refill(self, now: float) -> None:
        if self.at is None:
            self.at = now
        self.tokens = min(self.burst,
                          self.tokens + (now - self.at) * self.rate)
        self.at = now


class Quoter:
    """Token buckets keyed by resource path; consuming `amount` from
    "a/b" draws from "a" AND "a/b" (hierarchical throttling)."""

    def __init__(self, clock=None):
        self._clock = clock or time.monotonic
        self._buckets: dict[str, _Bucket] = {}
        self._lock = threading.Lock()

    def configure(self, path: str, rate: float,
                  burst: float | None = None) -> None:
        with self._lock:
            self._buckets[path] = _Bucket(
                rate, burst if burst is not None else rate)

    def _path_buckets(self, path: str) -> list[_Bucket]:
        parts = path.split("/")
        out = []
        for i in range(1, len(parts) + 1):
            b = self._buckets.get("/".join(parts[:i]))
            if b is not None:
                out.append(b)
        return out

    def try_acquire(self, path: str, amount: float = 1.0) -> bool:
        """All-or-nothing consume along the path; False = throttled."""
        now = self._clock()
        with self._lock:
            buckets = self._path_buckets(path)
            for b in buckets:
                b.refill(now)
            if any(b.tokens < amount for b in buckets):
                return False
            for b in buckets:
                b.tokens -= amount
            return True

    def exists(self, path: str) -> bool:
        with self._lock:
            return path in self._buckets

    def describe(self, path: str) -> dict | None:
        """{"rate", "burst", "tokens"} refreshed to now, or None."""
        now = self._clock()
        with self._lock:
            b = self._buckets.get(path)
            if b is None:
                return None
            b.refill(now)
            return {"rate": b.rate, "burst": b.burst,
                    "tokens": b.tokens}

    def wait_time(self, path: str, amount: float = 1.0) -> float:
        """Seconds until `amount` could be available (0 = now)."""
        now = self._clock()
        with self._lock:
            worst = 0.0
            for b in self._path_buckets(path):
                b.refill(now)
                if b.tokens < amount and b.rate > 0:
                    worst = max(worst, (amount - b.tokens) / b.rate)
            return worst


class ThrottledError(Exception):
    """Raised by callers when a quoter rejects a request."""
