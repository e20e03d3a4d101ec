"""Device choice for the port's entry points.

Every entry point (``TableBlock.from_numpy``, ``ScanExecutor``,
``entry``) takes an explicit ``device`` and defaults to CUDA. The CPU
is used only when the caller asks for it (the CPU tests do); with no GPU
and no explicit CPU the entry points raise instead of falling back.
"""

from __future__ import annotations

import contextlib
import threading

import torch

from ydb_tpu_torch.analysis import sanitizer

DEFAULT_DEVICE = "cuda"

#: Held by a CUDA graph capture (``ssa/plan_fuse.py``: warm-up and
#: capture) and by every worker thread around the CUDA work it issues
#: (block staging on a scan's producer thread, resident promotion). A
#: capture in the default mode fails when another thread calls the CUDA
#: API meanwhile, and the warm-up's ``set_sync_debug_mode("error")`` is
#: process-wide. A thread-sanitizer tracked lock always: it is built at
#: import, before a test can arm the sanitizer, and its idle cost is one
#: held-count update per acquire (the ``obs/probes.py`` registry idiom of
#: the reference).
capture_lock = sanitizer.TrackedRLock("device.capture_lock")


class DeviceWorkLock:
    """Reader-writer lock between statements' device work and CUDA graph
    captures.

    Statements hold it shared around the device work they issue
    (``plan.executor.execute_plan``, ``to_host``, the batcher's
    dispatch), so statements on different threads run at once. A CUDA
    graph capture (its warm-up under the process-wide
    ``set_sync_debug_mode("error")`` included) holds it exclusively: no
    other statement thread calls the CUDA API meanwhile, which would
    break the capture or trip the warm-up's sync check. Worker threads
    are kept out by ``capture_lock`` as before.

    Shared holds are re-entrant per thread. ``exclusive`` gives up the
    calling thread's own shared holds while it waits and takes them back
    after, so a statement that needs a capture does not wait for itself;
    waiting writers hold back new shared entries (no starvation).

    The thread sanitizer sees its holds: each shared hold as
    ``<name>[shared]`` (it protects reads only) and the exclusive hold as
    ``<name>`` (``analysis/sanitizer.py``, ``hold``/``unhold``).
    """

    def __init__(self, name: str = "device.work_lock"):
        self.name = name
        self._shared_name = name + sanitizer.SHARED
        self._cv = threading.Condition(threading.Lock())
        self._readers: dict[int, int] = {}
        self._writer: int | None = None
        self._writer_depth = 0
        self._writers_waiting = 0

    @contextlib.contextmanager
    def shared(self):
        me = threading.get_ident()
        with self._cv:
            if self._writer != me and not self._readers.get(me):
                while self._writer is not None or self._writers_waiting:
                    self._cv.wait()
            self._readers[me] = self._readers.get(me, 0) + 1
        sanitizer.hold(self._shared_name)
        try:
            yield
        finally:
            sanitizer.unhold(self._shared_name)
            with self._cv:
                left = self._readers[me] - 1
                if left:
                    self._readers[me] = left
                else:
                    del self._readers[me]
                    self._cv.notify_all()

    @contextlib.contextmanager
    def exclusive(self):
        me = threading.get_ident()
        with self._cv:
            held = 0
            if self._writer == me:
                self._writer_depth += 1
            else:
                held = self._readers.pop(me, 0)
                if held:
                    self._cv.notify_all()
                self._writers_waiting += 1
                try:
                    while self._writer is not None or self._readers:
                        self._cv.wait()
                finally:
                    self._writers_waiting -= 1
                self._writer = me
                self._writer_depth = 1
        sanitizer.hold(self.name)
        try:
            yield
        finally:
            sanitizer.unhold(self.name)
            with self._cv:
                self._writer_depth -= 1
                if self._writer_depth == 0:
                    self._writer = None
                    if held:  # back to the holds it came in with
                        self._readers[me] = held
                    self._cv.notify_all()

    def try_exclusive(self) -> bool:
        """Take the lock exclusively when that needs no wait (no other
        thread holds it); the caller then ``release_exclusive()``s."""
        me = threading.get_ident()
        with self._cv:
            if self._writer == me:
                self._writer_depth += 1
                sanitizer.hold(self.name)
                return True
            if self._writer is not None or any(
                    t != me for t in self._readers):
                return False
            self._writer = me
            self._writer_depth = 1
            sanitizer.hold(self.name)
            return True

    def release_exclusive(self) -> None:
        sanitizer.unhold(self.name)
        with self._cv:
            self._writer_depth -= 1
            if self._writer_depth == 0:
                self._writer = None
                self._cv.notify_all()


#: the process's one device work lock (see ``DeviceWorkLock``)
work_lock = DeviceWorkLock()


def resolve_device(device: "str | torch.device | None" = None) -> torch.device:
    """``device`` as a ``torch.device``; raise when CUDA is asked for (the
    default) and this process has no usable GPU."""
    dev = torch.device(DEFAULT_DEVICE if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "ydb_tpu_torch runs on a CUDA device by default and "
            "torch.cuda.is_available() is False here; pass device='cpu' "
            "to run on the CPU")
    return dev


def same_device(a, b) -> bool:
    """Whether two device specs name one device (``cuda`` is the current
    CUDA device)."""
    a, b = torch.device(a), torch.device(b)
    if a.type != b.type:
        return False
    if a.type != "cuda" or (a.index is not None and b.index is not None):
        return a.index == b.index
    cur = torch.cuda.current_device()
    return (cur if a.index is None else a.index) == \
        (cur if b.index is None else b.index)
