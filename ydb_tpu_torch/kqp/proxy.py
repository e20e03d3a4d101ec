"""KQP proxy: session pooling and request routing.

Mirror of the reference's kqp_proxy_service (ydb/core/kqp/proxy_service;
SURVEY §2.8 KQP-proxy row): clients do not own session lifecycles — the
proxy creates, pools, balances and expires sessions, enforcing a
ceiling, and routes each request to an idle session. Collapsed to one
process here, the contract is the same: bounded concurrent sessions,
reuse over churn, busy rejection past the ceiling.

The port's own copy of ``ydb_tpu/kqp/proxy.py``, over the port's
``Cluster`` (``kqp/session.py``).
"""

from __future__ import annotations

import collections
import threading


class ProxyBusyError(Exception):
    """All sessions busy and the pool is at its ceiling (the reference
    replies OVERLOADED)."""


class SessionPool:
    def __init__(self, cluster, max_sessions: int = 16):
        self.cluster = cluster
        self.max_sessions = max_sessions
        self._idle: collections.deque = collections.deque()
        self._created = 0
        self._lock = threading.Lock()
        self.stats = {"created": 0, "reused": 0, "busy_rejects": 0}

    def acquire(self):
        with self._lock:
            if self._idle:
                self.stats["reused"] += 1
                return self._idle.popleft()
            if self._created >= self.max_sessions:
                self.stats["busy_rejects"] += 1
                raise ProxyBusyError(
                    f"{self.max_sessions} sessions busy")
            self._created += 1
            self.stats["created"] += 1
        return self.cluster.session()

    def release(self, session) -> None:
        with self._lock:
            self._idle.append(session)

    def execute(self, sql: str):
        """Route one statement through a pooled session."""
        s = self.acquire()
        try:
            return s.execute(sql)
        finally:
            self.release(s)

    @property
    def idle(self) -> int:
        return len(self._idle)

    @property
    def live(self) -> int:
        return self._created
