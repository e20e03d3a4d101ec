"""lwtrace-analog probe points: near-zero-cost named events with
dynamically attached trace sessions.

Reference: the lwtrace library (ydb/library/lwtrace; SURVEY §2.1 row
'lwtrace probes') — probes compiled into hot paths fire only while a
trace session is attached, collecting events into per-session ring
buffers with filters. Same contract here: ``probe(name)`` returns a
module-level Probe whose ``fire(**params)`` is a single attribute check
when nothing is attached; sessions attach by glob pattern and keep a
bounded ring of (name, params) events plus per-probe hit counts.

The port's own copy of ``ydb_tpu/obs/probes.py``: the registry, the
per-scan ``StageTimer`` (whose charges also land on the data-movement
timeline, ``obs/timeline.py``) and ``memory_stats`` (host RSS plus the
CUDA caching allocator's counters). A timer's lock and accumulator are
sanitizer-tracked under YDB_TPU_TORCH_TSAN=1: the scan's producer and
consumer threads charge one timer concurrently.
"""

from __future__ import annotations

import collections
import contextlib
import fnmatch
import threading
import time

from ydb_tpu_torch.analysis import sanitizer
from ydb_tpu_torch.obs import timeline

# module-level registry: built at import, before any test could set
# YDB_TPU_TORCH_TSAN — so the proxy/lock are always-on variants whose
# recording self-gates per access (idle cost: one flag check on the
# probe() / attach() paths, never on fire())
_registry = sanitizer.share_always({}, "probes._registry")
_lock = sanitizer.TrackedLock("probes._lock")


class Probe:
    __slots__ = ("name", "_sessions")

    def __init__(self, name: str):
        self.name = name
        self._sessions: tuple = ()

    def fire(self, **params) -> None:
        sessions = self._sessions  # snapshot; () when idle (the fast path)
        for s in sessions:
            s._record(self.name, params)

    def __bool__(self) -> bool:
        """Truthy while any session listens: guards costly param
        computation (``if PROBE: PROBE.fire(expensive=...)``)."""
        return bool(self._sessions)


def probe(name: str) -> Probe:
    """Get-or-create the module-level probe point."""
    with _lock:
        p = _registry.get(name)
        if p is None:
            p = _registry[name] = Probe(name)
        return p


def list_probes() -> list[str]:
    with _lock:
        return sorted(_registry)


class TraceSession:
    """One attached collector (lwtrace session analog)."""

    def __init__(self, pattern: str = "*", capacity: int = 4096,
                 predicate=None):
        self.pattern = pattern
        self.predicate = predicate
        self.events: collections.deque = collections.deque(
            maxlen=capacity)
        self.counts: collections.Counter = collections.Counter()
        self._elock = threading.Lock()
        self._attached: list[Probe] = []

    def _record(self, name: str, params: dict) -> None:
        if self.predicate is not None and not self.predicate(name, params):
            return
        with self._elock:
            self.counts[name] += 1
            self.events.append((name, params))

    def attach(self) -> "TraceSession":
        with _lock:
            for name, p in _registry.items():
                if fnmatch.fnmatchcase(name, self.pattern):
                    p._sessions = p._sessions + (self,)
                    self._attached.append(p)
        return self

    def detach(self) -> None:
        with _lock:
            for p in self._attached:
                p._sessions = tuple(
                    s for s in p._sessions if s is not self)
            self._attached = []

    def __enter__(self) -> "TraceSession":
        return self.attach()

    def __exit__(self, *exc) -> None:
        self.detach()


class StageTimer:
    """Per-scan stage accounting: accumulated wall seconds by stage name.

    The scan pipeline spreads one logical query over threads — blob IO
    and K-way merging on the prefetch producer, block staging
    (pad + device transfer) beside it, device compute on the consumer —
    so a single end-to-end duration says nothing about WHERE the time
    went. Each pipeline site charges its own stage (``read`` / ``merge``
    / ``stage`` / ``compute``); concurrent stages may sum past the
    wall-clock total, which is exactly the overlap being measured.
    Thread-safe; ``snapshot()`` is what the ``scan.stages`` probe fires.
    """

    #: canonical scan stages, always present in snapshots (zero if unhit)
    STAGES = ("read", "merge", "stage", "compute")

    def __init__(self):
        self._t = sanitizer.share(collections.defaultdict(float),
                                  f"stagetimer.{id(self):x}")
        self._lock = sanitizer.make_lock(f"stagetimer.{id(self):x}.lock")

    def add(self, name: str, seconds: float, **args) -> None:
        # every stage charge ALSO lands on the data-movement timeline
        # (obs.timeline, default off) as an interval ending now — one
        # funnel, so timeline busy sums per stage equal the EXPLAIN
        # ANALYZE stage seconds by construction. ``args`` attach to the
        # ring interval (morsel ids from the streaming pipeline), never
        # to the stage accumulator — occupancy attribution stays exact
        # while each interval stays traceable to the work unit.
        if timeline.timeline_enabled():
            end = time.perf_counter()
            timeline.RING.record(
                f"stage.{name}", name, end - seconds, end,
                timeline.current_trace_id(), args or None)
        with self._lock:
            self._t[name] += seconds

    @contextlib.contextmanager
    def stage(self, name: str, **args):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.add(name, time.perf_counter() - t0, **args)

    def snapshot(self) -> dict:
        with self._lock:
            out = {s: 0.0 for s in self.STAGES}
            out.update(self._t)
        return {k: round(v, 6) for k, v in out.items()}


def memory_stats() -> dict:
    """Process + device memory observability (SURVEY §2.14 row
    'memory profiling'): VmRSS/VmHWM from /proc plus, per visible CUDA
    device, the caching allocator's bytes in use and peak. A process
    that never touched CUDA reports no device keys: reading them would
    start a CUDA context on a CPU-only caller."""
    out: dict = {}
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith(("VmRSS", "VmHWM")):
                    k, v = line.split(":", 1)
                    out[k.lower() + "_mb"] = round(
                        float(v.split()[0]) / 1024.0, 1)
    except OSError:
        pass
    import torch

    if torch.cuda.is_available() and torch.cuda.is_initialized():
        for i in range(torch.cuda.device_count()):
            st = torch.cuda.memory_stats(i)
            out[f"device{i}_bytes_in_use"] = st.get(
                "allocated_bytes.all.current", 0)
            out[f"device{i}_peak_bytes"] = st.get(
                "allocated_bytes.all.peak", 0)
    return out
