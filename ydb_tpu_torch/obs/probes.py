"""Per-scan stage accounting.

The port's own copy of ``StageTimer`` from ``ydb_tpu/obs/probes.py``
(without its data-movement timeline events); the probe registry and
memory statistics of that module wait for ROADMAP.md queue A item 7,
and the registry's tracked lock and proxy come with them. A timer's lock
and accumulator are sanitizer-tracked under YDB_TPU_TORCH_TSAN=1: the
scan's producer and consumer threads charge one timer concurrently.
"""

from __future__ import annotations

import collections
import contextlib
import time

from ydb_tpu_torch.analysis import sanitizer


class StageTimer:
    """Per-scan stage accounting: accumulated wall seconds by stage name.

    The scan pipeline spreads one logical query over threads — blob IO
    and K-way merging on the prefetch producer, block staging
    (pad + device transfer) beside it, device compute on the consumer —
    so a single end-to-end duration says nothing about WHERE the time
    went. Each pipeline site charges its own stage (``read`` / ``merge``
    / ``stage`` / ``compute``); concurrent stages may sum past the
    wall-clock total, which is exactly the overlap being measured.
    Thread-safe.
    """

    #: canonical scan stages, always present in snapshots (zero if unhit)
    STAGES = ("read", "merge", "stage", "compute")

    def __init__(self):
        self._t = sanitizer.share(collections.defaultdict(float),
                                  f"stagetimer.{id(self):x}")
        self._lock = sanitizer.make_lock(f"stagetimer.{id(self):x}.lock")

    def add(self, name: str, seconds: float, **args) -> None:
        # ``args`` (morsel ids from the streaming pipeline) label the
        # reference's timeline intervals; the accumulator ignores them
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
