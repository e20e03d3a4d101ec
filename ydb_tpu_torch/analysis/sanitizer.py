"""Runtime thread-sanitizer: lockset (Eraser-style) race detection for
the runtime's designated shared structures.

The static half (``analysis/concurrency.py``) proves lock DISCIPLINE;
this module catches what static analysis cannot see — dynamic call
paths, monkeypatched layers, test harness threads. With
``YDB_TPU_TORCH_TSAN=1`` the lock-bearing classes construct their locks
through :func:`make_lock` / :func:`make_condition` (which track the
per-thread held-lock set) and wrap their shared containers in
:func:`share` proxies that run the Eraser lockset algorithm per access:

  * while a single thread owns a structure, anything goes (init phase)
  * once a second thread touches it, the candidate lockset is the
    intersection of the locks held at every access
  * a WRITE with an empty candidate lockset raises :class:`RaceError`
    naming the structure, the operation, and the threads involved

Instrumented structures (wired in their owning modules): the conveyor
task heap and broker, the shard's scan cache and pruning totals, the
device block cache, the resident tier, the stream scheduler, the scan
share, the batcher, the statistics aggregator, the probe registry,
counter groups, the tracer and the session's active-statement registry.
When the env flag is off every factory returns the plain primitive —
zero overhead on the hot path.

The port's own copy of ``ydb_tpu/analysis/sanitizer.py``. What the
reference does not have: the process's two device locks
(``ydb_tpu_torch/device.py``). ``capture_lock`` is a
:class:`TrackedRLock` always (a module-level lock is built at import,
before a test can arm the sanitizer; its idle cost is one counter
update per acquire), and ``DeviceWorkLock`` reports its holds through
:func:`hold` / :func:`unhold`: exclusively as ``device.work_lock``,
shared as ``device.work_lock[shared]``. A shared hold protects reads
only — a write whose candidate lockset holds nothing but shared holds
is a race (the reader-writer refinement of Eraser). While TSAN is off a
hold costs one gate check; ``capture_lock``'s acquire costs its counter
update, the one tracking left on the disarmed path.
"""

from __future__ import annotations

import os
import threading


def enabled() -> bool:
    """YDB_TPU_TORCH_TSAN truthy, or force-activated by a test."""
    if _FORCE is not None:
        return _FORCE
    return os.environ.get("YDB_TPU_TORCH_TSAN", "0") not in ("0", "", "off")


_FORCE: "bool | None" = None


class RaceError(AssertionError):
    """Conflicting unsynchronized access to a shared structure."""


# ---- per-thread held-lock set ----

_HELD = threading.local()


def _held_counts() -> dict:
    counts = getattr(_HELD, "counts", None)
    if counts is None:
        counts = _HELD.counts = {}
    return counts


def held_locks() -> frozenset:
    """Names of tracked locks the calling thread currently holds."""
    return frozenset(k for k, v in _held_counts().items() if v > 0)


#: suffix of a hold that protects reads only (a reader-writer lock
#: held shared)
SHARED = "[shared]"


def hold(name: str) -> None:
    """Count one hold of ``name`` on the calling thread (a lock that is
    not a :class:`TrackedLock`, such as ``device.DeviceWorkLock``). A
    gate check and nothing else while TSAN is off."""
    if not enabled():
        return
    counts = _held_counts()
    counts[name] = counts.get(name, 0) + 1


def unhold(name: str) -> None:
    """Undo one :func:`hold` of ``name`` on the calling thread."""
    if not enabled():
        return
    counts = _held_counts()
    n = counts.get(name, 0)
    if n <= 1:
        counts.pop(name, None)
    else:
        counts[name] = n - 1


class TrackedLock:
    """threading.Lock wrapper feeding the held-lock set. Also works as
    the lock of a ``threading.Condition`` (wait/notify release and
    re-acquire through acquire/release, so tracking stays exact)."""

    _factory = staticmethod(threading.Lock)

    def __init__(self, name: str = "lock"):
        self.name = name
        self._inner = self._factory()

    def acquire(self, blocking: bool = True, timeout: float = -1):
        ok = self._inner.acquire(blocking, timeout)
        if ok:
            counts = _held_counts()
            counts[self.name] = counts.get(self.name, 0) + 1
        return ok

    def release(self) -> None:
        counts = _held_counts()
        n = counts.get(self.name, 0)
        if n <= 1:
            counts.pop(self.name, None)
        else:
            counts[self.name] = n - 1
        self._inner.release()

    def locked(self) -> bool:
        return self._inner.locked()

    def __enter__(self) -> "TrackedLock":
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()


class TrackedRLock(TrackedLock):
    _factory = staticmethod(threading.RLock)

    def locked(self) -> bool:  # RLock has no .locked before 3.12
        return bool(_held_counts().get(self.name, 0))

    # Condition's full-release protocol: an RLock acquired N deep must
    # release ALL levels across a wait() — delegate to the inner
    # RLock's implementation while zeroing/restoring the held count, so
    # tracking stays exact through nested with-blocks
    def _release_save(self):
        counts = _held_counts()
        depth = counts.pop(self.name, 0)
        return (self._inner._release_save(), depth)

    def _acquire_restore(self, saved):
        state, depth = saved
        self._inner._acquire_restore(state)
        if depth:
            _held_counts()[self.name] = depth

    def _is_owned(self):
        return self._inner._is_owned()


def make_lock(name: str):
    """A lock for a designated shared structure: tracked under TSAN,
    a plain threading.Lock otherwise (decided at construction)."""
    return TrackedLock(name) if enabled() else threading.Lock()


def make_rlock(name: str):
    return TrackedRLock(name) if enabled() else threading.RLock()


def make_condition(name: str):
    """Condition over a TRACKED RLock: a bare threading.Condition() is
    RLock-backed, so the sanitized variant must match — a re-entered
    ``with self._cv:`` must not deadlock only under TSAN."""
    return threading.Condition(TrackedRLock(name)) if enabled() \
        else threading.Condition()


# ---- Eraser lockset state ----

class _SharedState:
    __slots__ = ("name", "owner", "lockset", "threads", "write_seen")

    def __init__(self, name: str):
        self.name = name
        self.owner = None       # exclusive-phase thread id
        self.lockset = None     # None until a second thread appears
        self.threads: set = set()
        self.write_seen = False


_STATES: dict = {}
_meta_lock = threading.Lock()
#: one line per RaceError raised since the last reset (a race inside a
#: worker thread may be swallowed by its task handle; the list keeps it)
_REPORTS: list = []


def reports() -> list:
    """The races reported since the last :func:`reset_states`."""
    with _meta_lock:
        return list(_REPORTS)


def _state_for(name: str) -> _SharedState:
    with _meta_lock:
        st = _STATES.get(name)
        if st is None:
            st = _STATES[name] = _SharedState(name)
        return st


def reset_states() -> None:
    """Forget all lockset state (test isolation between stress runs).

    States reset IN PLACE, never dropped: long-lived proxies (the
    probe registry, the process-wide conveyor's heap token) hold direct
    references to their _SharedState, and replacing dict entries would
    split identity — the stale object keeps accumulating while fresh
    lookups see an empty one. In-place reset restores the exclusive
    init phase for every structure, old or new."""
    with _meta_lock:
        for st in _STATES.values():
            st.owner = None
            st.lockset = None
            st.threads = set()
            st.write_seen = False
        _REPORTS.clear()


def _record(st: _SharedState, op: str, write: bool) -> None:
    if not enabled():
        return  # always-on proxies (module registries) idle cheaply
    tid = threading.get_ident()
    held = held_locks()
    if write:  # a shared hold does not exclude the other readers
        held = frozenset(k for k in held if not k.endswith(SHARED))
    with _meta_lock:
        st.threads.add(tid)
        if st.owner is None:
            st.owner = tid
        if st.owner == tid and st.lockset is None:
            # exclusive phase: single-threaded init is always fine
            return
        if st.lockset is None:
            # second thread: candidate lockset starts from ITS locks;
            # writes before this point were unobserved init
            st.lockset = held
            st.write_seen = write
        else:
            st.lockset = st.lockset & held
            st.write_seen = st.write_seen or write
        if st.write_seen and not st.lockset:
            threads = sorted(st.threads)
            _REPORTS.append(f"{st.name}: {op} on thread {tid}")
            raise RaceError(
                f"unsynchronized access to {st.name}: {op} "
                f"({'write' if write else 'read'}) on thread {tid} "
                f"with locks {sorted(held) or '{}'} — candidate "
                f"lockset is empty across threads {threads}; a write "
                "is involved, so two of these accesses can interleave "
                "mid-operation. Guard every access with one lock "
                "(see analysis/README.md, C001)")


#: container reads worth recording (method names)
_READS = {
    "get", "items", "keys", "values", "copy", "index", "count",
}
#: container mutations
_WRITES = {
    "setdefault", "pop", "popitem", "update", "clear", "move_to_end",
    "append", "appendleft", "extend", "insert", "remove", "discard",
    "add", "sort", "reverse",
}


class ShareProxy:
    """Access-checking wrapper around a dict/list/set-like structure.

    Pure delegation: the wrapped object stays the single source of
    truth; the proxy only records (thread, locks-held) per access and
    runs the lockset check. Not a subclass — C-level bypasses (heapq)
    need explicit :func:`note` instrumentation instead.
    """

    __slots__ = ("_obj", "_st")

    def __init__(self, obj, state: _SharedState):
        object.__setattr__(self, "_obj", obj)
        object.__setattr__(self, "_st", state)

    # -- attribute-routed container methods --

    def __getattr__(self, name):
        attr = getattr(self._obj, name)
        if name in _WRITES or name in _READS:
            st = self._st
            write = name in _WRITES

            def op(*a, **k):
                _record(st, name, write)
                return attr(*a, **k)
            return op
        return attr

    # -- dunders (not routed through __getattr__) --

    def __getitem__(self, k):
        _record(self._st, "__getitem__", False)
        return self._obj[k]

    def __setitem__(self, k, v):
        _record(self._st, "__setitem__", True)
        self._obj[k] = v

    def __delitem__(self, k):
        _record(self._st, "__delitem__", True)
        del self._obj[k]

    def __contains__(self, k):
        _record(self._st, "__contains__", False)
        return k in self._obj

    def __len__(self):
        _record(self._st, "__len__", False)
        return len(self._obj)

    def __iter__(self):
        _record(self._st, "__iter__", False)
        return iter(self._obj)

    def __bool__(self):
        _record(self._st, "__bool__", False)
        return bool(self._obj)

    def __repr__(self):
        return f"ShareProxy({self._obj!r})"


def share(obj, name: str):
    """Wrap ``obj`` in an access-checking proxy under TSAN; return it
    untouched otherwise. Call at construction of the owning class."""
    if not enabled():
        return obj
    return ShareProxy(obj, _state_for(name))


def share_always(obj, name: str) -> ShareProxy:
    """Unconditional proxy for MODULE-level registries (constructed at
    import, before any test can set the env): recording self-gates on
    :func:`enabled` per access, so the idle cost is one flag check."""
    return ShareProxy(obj, _state_for(name))


def token(name: str) -> "_SharedState | None":
    """Explicit instrumentation handle for structures a proxy cannot
    intercept (heapq mutates lists at the C level). None when TSAN is
    off — callers skip :func:`note` on None."""
    return _state_for(name) if enabled() else None


def note(tok: "_SharedState | None", op: str,
         write: bool = True) -> None:
    """Record one access on an explicit instrumentation token."""
    if tok is not None:
        _record(tok, op, write)


class activate:
    """Context manager forcing TSAN on (tests): fresh lockset state on
    entry and exit so runs stay independent."""

    def __enter__(self) -> "activate":
        global _FORCE
        reset_states()
        with _meta_lock:
            _FORCE = True
        return self

    def __exit__(self, *exc) -> None:
        global _FORCE
        with _meta_lock:
            _FORCE = None
        reset_states()
