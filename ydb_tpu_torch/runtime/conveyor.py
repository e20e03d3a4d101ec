"""Background-task plane: conveyor worker pool + resource broker quotas.

The reference never runs maintenance on the user path: compactions, TTL
and GC are queued as tasks with categories and quotas through the
resource broker (ydb/core/tablet/resource_broker.h) and executed by the
conveyor's worker threads (ydb/core/tx/conveyor/service/service.h:73),
with an ICSController test seam to stall/step background work
(ydb/core/tx/columnshard/hooks/abstract/abstract.h:49).

The port's own copy of ``ydb_tpu/runtime/conveyor.py``, with its leak
handles, tracked locks and span propagation; the chaos and timeline
hooks come with ROADMAP.md queue A item 7. Background work is HOST work
(blob IO, merges, metadata) — the accelerator never blocks on it. This module provides:

  * ``ResourceBroker`` — per-queue concurrency quotas under one total
  * ``Conveyor``       — worker threads draining a priority queue,
                         gated per-task by the controller
  * ``ConveyorController`` — the test seam: stall / step / resume
"""

from __future__ import annotations

import dataclasses
import heapq
import itertools
import os
import threading
import time

from ydb_tpu_torch.analysis import leaksan, sanitizer
from ydb_tpu_torch.chaos import deadline as statement_deadline
from ydb_tpu_torch.obs import tracing

#: queue-wait samples retained per queue between ``queue_stats``
#: snapshots; beyond it the extra waits still count in the totals but
#: are not individually sampled (the histograms are statistical)
WAIT_SAMPLE_CAP = 512


class ConveyorController:
    """Test hook gating task execution (ICSController analog).

    ``stall()`` blocks workers before each task body; ``step(n)`` lets
    exactly n tasks through while stalled; ``resume()`` reopens fully.
    """

    def __init__(self):
        self._open = threading.Event()
        self._open.set()
        self._steps = threading.Semaphore(0)
        self._lock = threading.Lock()

    def stall(self) -> None:
        self._open.clear()

    def resume(self) -> None:
        self._open.set()

    def step(self, n: int = 1) -> None:
        for _ in range(n):
            self._steps.release()

    def _admit(self, stop: threading.Event | None = None) -> None:
        while not self._open.is_set():
            if stop is not None and stop.is_set():
                raise _Cancelled()
            # stalled: wait for either a step token or a resume, checking
            # the gate between waits so resume() always unblocks
            if self._steps.acquire(timeout=0.02):
                return


class _Cancelled(BaseException):
    """Task admitted during shutdown: surfaced through the handle."""


class ConveyorTimeout(TimeoutError):
    """Typed conveyor timeout: a handle wait that ran out of time, a
    broker slot not granted within the task's deadline, or wait_idle
    expiring (with the still-busy queues named). Callers can now tell
    'timed out' from 'task legitimately returned None'."""


class ResourceBroker:
    """Concurrency quotas per task queue under one total (the resource
    broker's queue configuration, resource_broker.h)."""

    def __init__(self, quotas: dict[str, int] | None = None,
                 total: int | None = None):
        self.quotas = dict(quotas or {})
        self.total = total
        self._running = sanitizer.share(
            {}, f"broker.{id(self):x}.running")
        self._all = 0
        self.rejected_deadline = 0  # guarded by _lock
        self._lock = sanitizer.make_lock(f"broker.{id(self):x}.lock")
        # a Condition over the tracked lock: wait/notify release and
        # re-acquire through it, so the held-set stays exact under TSAN
        self._freed = threading.Condition(self._lock)
        # leak-sanitizer grant handles per queue (guarded by _freed);
        # empty whenever the sanitizer is off
        self._leaks: dict[str, list] = {}

    def acquire(self, queue: str,
                stop: threading.Event | None = None,
                deadline: "statement_deadline.Deadline | None" = None
                ) -> None:
        """Wait for a slot. ``deadline`` bounds the wait: a task whose
        statement budget expires while queued for admission raises
        :class:`ConveyorTimeout` instead of holding the admission path
        (chaos-delayed tasks can otherwise wedge a quota forever)."""
        with self._freed:
            while not self._may_run(queue):
                if stop is not None and stop.is_set():
                    raise _Cancelled()
                if deadline is not None:
                    remaining = deadline.remaining()
                    if remaining <= 0.0:
                        self.rejected_deadline += 1
                        raise ConveyorTimeout(
                            f"broker slot for {queue!r} not granted "
                            "within the task deadline")
                    self._freed.wait(timeout=min(remaining, 0.1))
                else:
                    self._freed.wait(timeout=0.1)
            self._running[queue] = self._running.get(queue, 0) + 1
            self._all += 1
            lk = leaksan.track("broker.slot", queue)
            if lk is not None:
                self._leaks.setdefault(queue, []).append(lk)

    def _may_run(self, queue: str) -> bool:
        if self.total is not None and self._all >= self.total:
            return False
        q = self.quotas.get(queue)
        return q is None or self._running.get(queue, 0) < q

    def release(self, queue: str) -> None:
        with self._freed:
            self._running[queue] -= 1
            self._all -= 1
            if self._leaks:
                hs = self._leaks.get(queue)
                if hs:
                    hs.pop().close()
            self._freed.notify_all()


@dataclasses.dataclass
class TaskHandle:
    queue: str
    done: threading.Event
    result: object = None
    error: BaseException | None = None
    #: statement deadline captured at submit (None = unbounded); bounds
    #: the broker admission wait on the worker
    deadline: object = None
    #: leak-sanitizer handle opened at submit, closed when done is set
    #: (None whenever the sanitizer is off)
    leak: object = None

    def wait(self, timeout: float | None = None):
        if not self.done.wait(timeout):
            raise ConveyorTimeout(
                f"background task ({self.queue}) pending after "
                f"{timeout}s")
        if self.error is not None:
            raise self.error
        return self.result


class Conveyor:
    """Worker pool for background jobs (compaction/TTL/GC off the commit
    path). Priorities: lower value first; FIFO within a priority."""

    def __init__(self, workers: int = 2,
                 broker: ResourceBroker | None = None,
                 controller: ConveyorController | None = None):
        self.broker = broker or ResourceBroker()
        self.controller = controller or ConveyorController()
        self._heap: list = []
        # heapq mutates the list at the C level, bypassing any proxy:
        # the push/pop sites carry explicit sanitizer notes instead
        self._heap_tok = sanitizer.token(f"conveyor.{id(self):x}.heap")
        self._seq = itertools.count()
        self._cv = sanitizer.make_condition(f"conveyor.{id(self):x}.cv")
        # queue telemetry, all guarded by _cv: lifetime totals, the
        # depth high-water mark since the last queue_stats() snapshot,
        # and per-queue wait-time samples drained on that cadence
        self._submitted = 0
        self._completed = 0
        self._rejected = 0
        self._max_depth = 0
        self._waits = sanitizer.share(
            {}, f"conveyor.{id(self):x}.waits")
        self._stopping = False
        self._stop_event = threading.Event()
        self._active = 0
        # per-queue running-task counts (guarded by _cv): lets wait_idle
        # name the queues that were still busy when it gave up
        self._active_q: dict[str, int] = {}
        self._threads = [
            threading.Thread(target=self._worker, daemon=True)
            for _ in range(workers)
        ]
        for t in self._threads:
            t.start()

    def submit(self, queue: str, fn, *args, priority: int = 10,
               **kwargs) -> TaskHandle:
        # the submitter's active trace span AND statement deadline follow
        # the task onto the worker thread (scan prefetch producers record
        # under the query's trace id and observe its cancellation);
        # no-ops when neither is active
        fn = tracing.wrap_current(fn)
        fn = statement_deadline.wrap_current(fn)
        h = TaskHandle(queue, threading.Event(),
                       deadline=statement_deadline.current(),
                       leak=leaksan.track("conveyor.task", queue))
        with self._cv:
            if self._stopping:
                leaksan.close(h.leak)
                raise RuntimeError("conveyor is shut down")
            sanitizer.note(self._heap_tok, "heappush")
            heapq.heappush(
                self._heap,
                (priority, next(self._seq), queue, fn, args, kwargs, h,
                 time.perf_counter()))
            self._submitted += 1
            self._max_depth = max(self._max_depth, len(self._heap))
            self._cv.notify()
        return h

    def submit_if_free(self, queue: str, fn, *args,
                       **kwargs) -> TaskHandle | None:
        """Submit ONLY if an idle worker can take the task right now
        (atomic check-and-push), else None. For long-lived pipeline
        tasks (scan prefetch producers) that must never queue behind
        each other: a parked producer whose consumer is itself waiting
        on a queued producer would starve — callers degrade to a
        synchronous path instead."""
        fn = tracing.wrap_current(fn)  # trace follows the producer
        fn = statement_deadline.wrap_current(fn)  # so does the deadline
        with self._cv:
            if (self._stopping or self._heap
                    or self._active >= len(self._threads)):
                self._rejected += 1
                return None
            h = TaskHandle(queue, threading.Event(),
                           deadline=statement_deadline.current(),
                           leak=leaksan.track("conveyor.task", queue))
            sanitizer.note(self._heap_tok, "heappush")
            heapq.heappush(
                self._heap,
                (10, next(self._seq), queue, fn, args, kwargs, h,
                 time.perf_counter()))
            self._submitted += 1
            self._max_depth = max(self._max_depth, len(self._heap))
            self._cv.notify()
            return h

    def pending(self, queue: str | None = None) -> int:
        """Queued (not yet running) task count, optionally for one
        queue — promotion-backlog observability for the resident tier
        (a deep "resident_promote" backlog means HBM promotion is
        falling behind ingest)."""
        with self._cv:
            if queue is None:
                return len(self._heap)
            return sum(1 for item in self._heap if item[2] == queue)

    def queue_stats(self) -> dict:
        """Telemetry snapshot: lifetime submitted/completed/rejected
        totals, instantaneous depth/active, the depth high-water mark
        since the LAST snapshot (reset here), and the per-queue wait
        seconds sampled since then (drained here — the background
        cadence folds them into the ``component="conveyor"``
        histograms)."""
        with self._cv:
            waits = {q: list(v) for q, v in self._waits.items()}
            self._waits.clear()
            out = {
                "submitted": self._submitted,
                "completed": self._completed,
                "rejected": self._rejected,
                "rejected_deadline": self.broker.rejected_deadline,
                "depth": len(self._heap),
                "active": self._active,
                "workers": len(self._threads),
                "max_depth": self._max_depth,
                "waits": waits,
            }
            self._max_depth = len(self._heap)
        return out

    def _worker(self) -> None:
        while True:
            with self._cv:
                while not self._heap and not self._stopping:
                    self._cv.wait()
                if self._stopping and not self._heap:
                    return
                sanitizer.note(self._heap_tok, "heappop")
                _, _, queue, fn, args, kwargs, h, t_sub = heapq.heappop(
                    self._heap)
                self._active += 1
                self._active_q[queue] = self._active_q.get(queue, 0) + 1
                t_pop = time.perf_counter()
                ws = self._waits.get(queue)
                if ws is None:
                    ws = self._waits[queue] = []
                if len(ws) < WAIT_SAMPLE_CAP:
                    ws.append(t_pop - t_sub)
            try:
                try:
                    # stop-aware gates: shutdown() while the controller
                    # is stalled (or a quota is exhausted) cancels the
                    # popped task instead of wedging the worker; an
                    # expired task deadline bounds the broker wait
                    self.controller._admit(self._stop_event)
                    self.broker.acquire(queue, self._stop_event,
                                        deadline=h.deadline)
                except _Cancelled:
                    h.error = RuntimeError(
                        "conveyor shut down before the task ran")
                    continue
                except ConveyorTimeout as e:
                    h.error = e  # slot never granted: nothing to release
                    continue
                try:
                    h.result = fn(*args, **kwargs)
                except BaseException as e:  # surfaced via handle.wait()
                    h.error = e
                finally:
                    self.broker.release(queue)
            finally:
                leaksan.close(h.leak)
                h.done.set()
                with self._cv:
                    self._active -= 1
                    self._active_q[queue] -= 1
                    self._completed += 1
                    self._cv.notify_all()

    def wait_idle(self, timeout: float = 30.0) -> None:
        deadline = threading.Event()
        t = threading.Timer(timeout, deadline.set)
        t.start()
        try:
            with self._cv:
                while (self._heap or self._active) and not deadline.is_set():
                    self._cv.wait(timeout=0.05)
                if self._heap or self._active:
                    # name the stuck queues: queued items still in the
                    # heap plus tasks running right now
                    busy = sorted(
                        {item[2] for item in self._heap}
                        | {q for q, n in self._active_q.items() if n})
                    raise ConveyorTimeout(
                        f"conveyor busy after {timeout}s: "
                        f"queues={busy}")
        finally:
            t.cancel()

    def shutdown(self, wait: bool = True) -> None:
        with self._cv:
            self._stopping = True
            self._stop_event.set()
            self._cv.notify_all()
        if wait:
            for t in self._threads:
                t.join(timeout=10)


_shared: Conveyor | None = None
_shared_lock = threading.Lock()
_stream: Conveyor | None = None
_stream_lock = threading.Lock()


def shared_conveyor() -> Conveyor:
    """Process-wide conveyor for scan prefetch/staging work.

    Before this pool every ``stream_blocks`` spun up (and tore down) its
    own ``ThreadPoolExecutor(1)`` — thread churn per scan, and no global
    bound on prefetch concurrency. The shared pool gives both: workers
    are created ONCE (YDB_TPU_TORCH_CONVEYOR_WORKERS, default 4) and every
    scan's staging producer runs as a "scan_prefetch" task on them.

    A scan's producer occupies one worker for the scan's lifetime (it
    parks on a bounded queue between blocks), so the worker count bounds
    how many block streams stage CONCURRENTLY; with every worker busy,
    additional streams do NOT queue — ``submit_if_free`` turns them away
    and ``stream_blocks`` degrades to synchronous (no-prefetch) staging,
    which can never starve but loses the overlap. Never shut this
    instance down — its threads are daemons and die with the process.
    """
    global _shared
    with _shared_lock:
        if _shared is None:
            workers = int(os.environ.get("YDB_TPU_TORCH_CONVEYOR_WORKERS", "4"))
            _shared = Conveyor(workers=max(1, workers))
        return _shared


def stream_conveyor() -> Conveyor:
    """Process-wide pool for morsel IO/decode tasks
    (engine.stream_sched) — deliberately SEPARATE from
    ``shared_conveyor``.

    The shared pool's workers host long-lived scan staging PRODUCERS
    that park for a scan's whole lifetime; short morsel tasks queued
    behind them could wait on workers that never free while the
    producers themselves wait on those morsels — a cycle. A dedicated
    pool breaks it structurally, and the scheduler's work stealing
    (engine.stream_sched) keeps even THIS pool's saturation from ever
    blocking a consumer: an unstarted head morsel runs inline instead.
    Unlike the shared pool, tasks here queue freely (they are finite,
    not scan-lifetime), so ``submit`` is the right admission, not
    ``submit_if_free``. YDB_TPU_TORCH_STREAM_WORKERS sizes it (default 4).
    Never shut this instance down — its threads are daemons and die
    with the process."""
    global _stream
    with _stream_lock:
        if _stream is None:
            workers = int(os.environ.get("YDB_TPU_TORCH_STREAM_WORKERS", "4"))
            _stream = Conveyor(workers=max(1, workers))
        return _stream
