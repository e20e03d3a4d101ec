"""Runtime leak sanitizer: every tracked resource handle must drain.

The static half (``analysis/lifecycle.py``) proves acquire/release
PAIRING; this module catches what static analysis cannot see — dynamic
call paths, chaos-injected faults, cancellation racing a release. With
``YDB_TPU_TORCH_LEAKSAN=1`` the resource-bearing layers wrap their
acquire/release sites in :func:`track` handles:

  * conveyor.task       — a submitted task until its handle completes
  * broker.slot         — a ResourceBroker grant until release()
  * resident.flight     — a ResidentStore single-flight promotion
  * blockcache.flight   — a DeviceBlockCache single-flight fill
  * stream.morsel       — a StreamScheduler morsel slab in flight
  * scanshare.flight    — a SharedScanRegistry staging flight
  * batch.member        — a BatchDispatcher seat
  * dq.spill            — a Spiller payload until loaded or dropped
  * session.active      — a statement's in-flight registry row
  * rm.slot             — a ResourceManager compute-slot grant
  * serving.conn        — a pgwire connection
  * serving.seat        — a front-door admission seat

Each live handle retains its creation-site stack, so
:func:`assert_drained` — hooked at statement completion (per-owner) and
``Cluster.stop`` (global) — raises :class:`LeakError` naming exactly
which handles leaked and where they were acquired.

Disabled (the default), every :func:`track` site costs one module-global
bool check returning ``None`` and every :func:`close` a ``None`` test —
safe to leave compiled into hot paths. Like ``sanitizer``, this module
keeps a bare dependency set (os + threading + traceback) so the
low-level runtime modules can import it unconditionally.

The port's own copy of ``ydb_tpu/analysis/leaksan.py``; the env gate is
``YDB_TPU_TORCH_LEAKSAN``.
"""

from __future__ import annotations

import os
import threading
import traceback

#: In-process override of the YDB_TPU_TORCH_LEAKSAN env gate (the
#: chaos.CHAOS_FORCE idiom): None = follow the environment, True/False
#: = force. Set via :func:`set_force` (or :class:`activate`) so the
#: hot-path gate recomputes.
LEAKSAN_FORCE: "bool | None" = None

#: creation-stack frames retained per handle: enough to name the
#: acquire site and its caller without making armed tracking heavy
STACK_DEPTH = 8


def enabled() -> bool:
    if LEAKSAN_FORCE is not None:
        return LEAKSAN_FORCE
    return os.environ.get("YDB_TPU_TORCH_LEAKSAN", "0") not in ("0", "", "off")


# the single check on the disabled hot path (chaos._ARMED idiom):
# recomputed whenever the force pin or (via refresh()) the env changes
_ON = enabled()

#: guards the handle registry AND the gate writes (chaos._state_lock
#: idiom); hot-path READS of _ON stay lock-free by design
_meta_lock = threading.Lock()


def refresh() -> None:
    """Recompute the hot-path gate after an environment change (tests
    that monkeypatch YDB_TPU_TORCH_LEAKSAN call this; set_force calls it)."""
    global _ON
    with _meta_lock:
        _ON = enabled()


def set_force(value: "bool | None") -> None:
    """Pin the gate in-process (True/False) or return to the
    environment (None)."""
    global LEAKSAN_FORCE, _ON
    with _meta_lock:
        LEAKSAN_FORCE = value
        _ON = enabled()


class LeakError(AssertionError):
    """A tracked resource handle outlived its drain point."""


class Handle:
    """One live acquisition of a tracked resource kind."""

    __slots__ = ("kind", "site", "owner", "seq", "stack", "closed")

    def __init__(self, kind: str, site: str, owner, seq: int,
                 stack: list):
        self.kind = kind
        self.site = site
        self.owner = owner
        self.seq = seq
        self.stack = stack
        self.closed = False

    def close(self) -> None:
        """Idempotent: a handle released twice (retry paths) is fine —
        double-release bugs are the lifecycle analyzer's beat."""
        if self.closed:
            return
        self.closed = True
        with _meta_lock:
            _LIVE.pop(self.seq, None)

    def describe(self) -> str:
        where = "".join(traceback.format_list(self.stack[-3:])).rstrip()
        return (f"{self.kind}[{self.site}]"
                + (f" owner={self.owner}" if self.owner is not None
                   else "")
                + f" acquired at:\n{where}")


_LIVE: dict = {}  # seq -> Handle
_seq = 0


def track(kind: str, site: str = "", owner=None) -> "Handle | None":
    """Open a handle around a resource acquisition. Returns None when
    the sanitizer is off (one module-global bool per call site); the
    matching release calls :func:`close` on whatever this returned."""
    if not _ON:
        return None
    global _seq
    stack = traceback.extract_stack(limit=STACK_DEPTH)[:-1]
    with _meta_lock:
        _seq += 1
        h = Handle(kind, site, owner, _seq, stack)
        _LIVE[h.seq] = h
    return h


def close(handle: "Handle | None") -> None:
    """Release the handle a :func:`track` site returned (None-safe, so
    disabled-path call sites stay branch-free)."""
    if handle is not None:
        handle.close()


def live(kind: "str | None" = None, owner=None) -> list:
    """Currently open handles, optionally filtered by kind/owner."""
    with _meta_lock:
        hs = list(_LIVE.values())
    return [h for h in hs
            if (kind is None or h.kind == kind)
            and (owner is None or h.owner == owner)]


def counts() -> dict:
    """Live-handle gauge per kind (the drain-to-zero surface the soak
    and chaos acceptance tests assert on). Empty dict when drained."""
    out: dict = {}
    with _meta_lock:
        for h in _LIVE.values():
            out[h.kind] = out.get(h.kind, 0) + 1
    return out


def assert_drained(kinds=None, owner=None, where: str = "") -> None:
    """Raise :class:`LeakError` naming every live handle (optionally
    scoped to ``kinds`` and/or ``owner``). No-op when disabled — the
    hooks in Session.execute / Cluster.stop cost one bool when off."""
    if not _ON:
        return
    leaked = [h for h in live(owner=owner)
              if kinds is None or h.kind in kinds]
    if not leaked:
        return
    names = "\n\n".join(h.describe() for h in leaked[:8])
    more = f"\n... and {len(leaked) - 8} more" if len(leaked) > 8 else ""
    raise LeakError(
        f"{len(leaked)} leaked resource handle(s)"
        + (f" at {where}" if where else "") + f":\n{names}{more}")


def reset() -> None:
    """Forget all live handles (test isolation between runs)."""
    with _meta_lock:
        _LIVE.clear()


class activate:
    """Context manager forcing the sanitizer on (tests): fresh handle
    state on entry and exit so runs stay independent."""

    def __enter__(self) -> "activate":
        reset()
        set_force(True)
        return self

    def __exit__(self, *exc) -> None:
        set_force(None)
        reset()
