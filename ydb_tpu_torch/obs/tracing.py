"""Distributed tracing: spans with trace-id propagation.

Mirror of the reference's Wilson tracing (NWilson::TSpan
wilson/wilson_span.h:50, TTraceId wilson/wilson_trace.h, uploader ->
OTLP wilson/wilson_uploader.cpp; SURVEY.md §5.1): spans open under a
trace id, nest by parent span id, and finished spans collect in a
Tracer which exports OTLP-shaped JSON. The session opens a root span
per query; inner phases (parse/plan/compile/execute/scan/fetch) nest
under it; actor envelopes can carry the id across nodes.

Span threading: the ACTIVE span rides thread-local context
(``activate`` / ``current_span`` / ``span``), so deep layers — the
scan executor, DQ compute actors, the conveyor prefetch pool — attach
children without plumbing a span argument through every signature.
``runtime.conveyor`` captures the submitter's active span and
re-activates it on the worker, so one query's trace id follows its
work across threads; the Tracer is therefore thread-safe (spans
finish from prefetch producers while the session thread records its
own) with a per-trace-id index replacing the old linear scan.

Gating: profiling is ON by default; ``YDB_TPU_TORCH_PROFILE=0`` keeps the
per-query root span but skips activation, so no child spans (and none
of their attribute computation) happen anywhere below the session.
``PROFILE_FORCE`` is the in-process test override (same contract as
stats.STATS_FORCE).

The port's own copy of ``ydb_tpu/obs/tracing.py``. Left out: the
timeline ring that finished spans also feed in the reference (its
``obs/timeline.py``; ROADMAP.md queue A item 7).
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import threading
import time

from ydb_tpu_torch.analysis import sanitizer


_ids = itertools.count(1)

#: test/bench override: True/False forces profiling regardless of the
#: environment (same contract as kernels.FUSED_FORCE).
PROFILE_FORCE: bool | None = None


def profiling_enabled() -> bool:
    """Whether the session threads its span through the query path
    (activation + child spans + profile assembly). Default on;
    ``YDB_TPU_TORCH_PROFILE=0`` restores the root-span-only behavior."""
    if PROFILE_FORCE is not None:
        return PROFILE_FORCE
    return os.environ.get("YDB_TPU_TORCH_PROFILE", "1") not in ("0", "", "off")


class Span:
    def __init__(self, tracer: "Tracer", name: str, trace_id: int,
                 parent_id: int | None = None, clock=time.monotonic):
        self.tracer = tracer
        self.name = name
        self.trace_id = trace_id
        self.span_id = next(_ids)
        self.parent_id = parent_id
        self.attrs: dict = {}
        self._clock = clock
        self.start = clock()
        self.end: float | None = None

    #: real spans record; the shared null span (disabled path) does not
    recording = True

    def child(self, name: str) -> "Span":
        return Span(self.tracer, name, self.trace_id, self.span_id,
                    self._clock)

    def set(self, **attrs) -> "Span":
        self.attrs.update(attrs)
        return self

    @property
    def seconds(self) -> float:
        """Wall duration (to now while unfinished)."""
        return (self.end if self.end is not None
                else self._clock()) - self.start

    def finish(self) -> None:
        if self.end is None:
            self.end = self._clock()
            self.tracer._record(self)

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc is not None:
            self.attrs["error"] = repr(exc)
        self.finish()


class _NullSpan:
    """No-op span: returned by ``span()`` when no trace is active, so
    instrumentation sites need no ``if`` around their annotations."""

    recording = False
    trace_id = 0
    span_id = 0
    parent_id = None
    attrs: dict = {}
    seconds = 0.0

    def child(self, name: str) -> "_NullSpan":
        return self

    def set(self, **attrs) -> "_NullSpan":
        return self

    def finish(self) -> None:
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        pass


NULL_SPAN = _NullSpan()

# thread-local active span; workers inherit it via ``wrap_current``
_tls = threading.local()


def current_span() -> Span | None:
    """The thread's active span (None outside any activated trace)."""
    return getattr(_tls, "span", None)


@contextlib.contextmanager
def activate(sp: Span):
    """Make ``sp`` the thread's active span for the block."""
    prev = current_span()
    _tls.span = sp
    try:
        yield sp
    finally:
        _tls.span = prev


@contextlib.contextmanager
def span(name: str, **attrs):
    """Open (and activate) a child of the active span; a shared no-op
    span when no trace is active — the disabled path costs one
    thread-local read."""
    parent = current_span()
    if parent is None:
        yield NULL_SPAN
        return
    s = parent.child(name)
    if attrs:
        s.set(**attrs)
    prev = parent
    _tls.span = s
    try:
        yield s
    except BaseException as e:
        s.attrs["error"] = repr(e)
        raise
    finally:
        _tls.span = prev
        s.finish()


def annotate(**attrs) -> None:
    """Attach attributes to the active span, if any."""
    sp = current_span()
    if sp is not None:
        sp.set(**attrs)


def wrap_current(fn):
    """Bind the submitter's active span to ``fn`` so a worker thread
    runs it under the same trace (the conveyor submit hook)."""
    sp = current_span()
    if sp is None:
        return fn

    def bound(*args, **kwargs):
        with activate(sp):
            return fn(*args, **kwargs)

    return bound


class Tracer:
    """Thread-safe span collector with a per-trace-id index.

    DQ stages and conveyor prefetch producers finish spans from worker
    threads while the session thread records its own — ``finished``
    appends and ``spans_for`` lookups run under a sanitizer-tracked
    lock, and the index makes per-query lookups O(spans in trace)
    instead of a scan over the whole ring."""

    def __init__(self, max_spans: int = 10000, clock=time.monotonic):
        self.max_spans = max_spans
        self.finished: list[Span] = []
        self._by_trace: dict[int, list[Span]] = {}
        self._lock = sanitizer.make_lock(f"tracer.{id(self):x}.lock")
        self._clock = clock
        self._next_tid = 1

    def trace(self, name: str, trace_id: int | None = None) -> Span:
        """Open a root span (new trace id unless one is propagated).
        The local allocator always skips past propagated ids so two
        unrelated traces never share an id."""
        with self._lock:
            if trace_id is not None:
                tid = trace_id
                self._next_tid = max(self._next_tid, trace_id + 1)
            else:
                tid = self._next_tid
                self._next_tid += 1
        return Span(self, name, tid, None, self._clock)

    def _record(self, span: Span) -> None:
        with self._lock:
            self.finished.append(span)
            self._by_trace.setdefault(span.trace_id, []).append(span)
            excess = len(self.finished) - self.max_spans
            if excess > 0:
                evicted = self.finished[:excess]
                del self.finished[:excess]
                for s in evicted:
                    spans = self._by_trace.get(s.trace_id)
                    if spans is not None:
                        spans.remove(s)
                        if not spans:
                            del self._by_trace[s.trace_id]

    def spans_for(self, trace_id: int) -> list[Span]:
        with self._lock:
            return list(self._by_trace.get(trace_id, ()))

    def export_otlp_json(self) -> str:
        """OTLP/JSON-shaped export (the uploader's wire format)."""
        with self._lock:
            spans = list(self.finished)
        return json.dumps({
            "resourceSpans": [{
                "scopeSpans": [{
                    "spans": [{
                        "traceId": f"{s.trace_id:032x}",
                        "spanId": f"{s.span_id:016x}",
                        "parentSpanId": (f"{s.parent_id:016x}"
                                         if s.parent_id else ""),
                        "name": s.name,
                        "startTimeUnixNano": int(s.start * 1e9),
                        "endTimeUnixNano": int((s.end or s.start) * 1e9),
                        "attributes": [
                            {"key": k, "value": {"stringValue": str(v)}}
                            for k, v in s.attrs.items()
                        ],
                    } for s in spans],
                }],
            }],
        })
