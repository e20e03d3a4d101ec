"""Statement deadlines and cooperative cancellation.

The port's own copy of ``ydb_tpu/chaos/deadline.py``. A caller
activates a :class:`Deadline` on its thread (``activate``); the DQ
compute actors check it cooperatively at each source block boundary
(``current()`` + ``expired()``), and the plan executor turns a graph
aborted that way into :class:`StatementCancelled`. The disabled path is
one thread-local read.
"""

from __future__ import annotations

import contextlib
import threading
import time


class StatementCancelled(Exception):
    """The statement exceeded its deadline (or was cancelled)."""

    reason = "cancelled"


class Deadline:
    """A wall-clock budget: ``Deadline(seconds=0.5)`` or an absolute
    ``Deadline(at=monotonic_instant)``."""

    __slots__ = ("at",)

    def __init__(self, seconds: float | None = None,
                 at: float | None = None):
        if at is None:
            if seconds is None:
                raise ValueError("Deadline needs seconds= or at=")
            at = time.monotonic() + seconds
        self.at = at

    def remaining(self) -> float:
        return self.at - time.monotonic()

    def expired(self) -> bool:
        return time.monotonic() >= self.at

    def check(self, what: str = "statement") -> None:
        if time.monotonic() >= self.at:
            raise StatementCancelled(f"{what}: deadline exceeded")


_tls = threading.local()


def current() -> Deadline | None:
    """The thread's active statement deadline (None when unbounded)."""
    return getattr(_tls, "deadline", None)


@contextlib.contextmanager
def activate(dl: Deadline | None):
    """Make ``dl`` the thread's deadline for the block. ``activate(None)``
    explicitly clears it."""
    prev = getattr(_tls, "deadline", None)
    _tls.deadline = dl
    try:
        yield dl
    finally:
        _tls.deadline = prev


def check_current(what: str = "statement") -> None:
    """The cooperative cancellation point: raise ``StatementCancelled``
    if the thread's deadline has passed. Disabled path = one
    thread-local read."""
    dl = getattr(_tls, "deadline", None)
    if dl is not None and time.monotonic() >= dl.at:
        raise StatementCancelled(f"{what}: deadline exceeded")

