"""Shared retry policy: exponential backoff + jitter + deadline cap.

The port's own copy of ``ydb_tpu/chaos/retry.py``. One policy object
serves every transient-failure surface (blob reads in
engine/portion.py) so backoff shape and counters are uniform. Retries
respect the statement :class:`~ydb_tpu_torch.chaos.deadline.Deadline`
active on the calling thread: no retry ever sleeps past the statement's
budget, and an expired deadline stops retrying immediately (the last
error propagates; the cancellation machinery turns it into a typed
failure at the statement boundary).

Counters + the ``blob.retry`` probe + span annotation live here (see
``note_retry``), so every retry loop surfaces identically.
"""

from __future__ import annotations

import dataclasses
import random
import threading
import time

from ydb_tpu_torch.chaos import deadline as _deadline

_rng = random.Random(0x5EED)  # jitter only; correctness never depends on it
_counters_lock = threading.Lock()
_RETRIES: dict[str, int] = {}


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Exponential backoff with +/-``jitter`` randomization, capped per
    attempt at ``max_delay`` and overall by the active deadline."""

    max_attempts: int = 4
    base_delay: float = 0.002
    multiplier: float = 2.0
    max_delay: float = 0.25
    jitter: float = 0.25

    def delay(self, attempt: int, rng: random.Random | None = None
              ) -> float:
        d = min(self.base_delay * self.multiplier ** attempt,
                self.max_delay)
        if self.jitter:
            r = (rng or _rng).random()
            d *= 1.0 + self.jitter * (2.0 * r - 1.0)
        return max(d, 0.0)

    def call(self, fn, *, site: str = "blob.read",
             retry_on: tuple = (OSError,),
             deadline: "_deadline.Deadline | None" = None):
        """Run ``fn()``; on a ``retry_on`` error back off and retry up
        to ``max_attempts`` total tries. The deadline cap uses the
        explicit ``deadline`` or the thread's active statement deadline.
        """
        attempt = 0
        while True:
            try:
                return fn()
            except retry_on as e:
                attempt += 1
                if attempt >= self.max_attempts:
                    raise
                dl = deadline if deadline is not None \
                    else _deadline.current()
                d = self.delay(attempt - 1)
                if dl is not None:
                    remaining = dl.remaining()
                    if remaining <= 0.0:
                        raise  # no retry budget left for this statement
                    d = min(d, remaining)
                note_retry(site, attempt, e)
                time.sleep(d)


def note_retry(site: str, attempt: int, error: BaseException) -> None:
    """Count a retry and surface it: ``blob.retry`` probe + a ``retries``
    attribute on the active span (EXPLAIN ANALYZE shows absorbed
    retries)."""
    with _counters_lock:
        _RETRIES[site] = _RETRIES.get(site, 0) + 1
    from ydb_tpu_torch.obs import probes, tracing
    pr = probes.probe("blob.retry")
    if pr:
        pr.fire(site=site, attempt=attempt,
                error=type(error).__name__)
    sp = tracing.current_span()
    if sp is not None:
        sp.set(retries=sp.attrs.get("retries", 0) + 1)


def retry_counters() -> dict[str, int]:
    with _counters_lock:
        return dict(_RETRIES)


def clear_counters() -> None:
    with _counters_lock:
        _RETRIES.clear()
