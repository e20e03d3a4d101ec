"""Dynamic counters: hierarchical metric trees + Prometheus text export.

Mirror of the reference's monlib dynamic counters (TDynamicCounters
library/cpp/monlib/dynamic_counters/counters.h; SURVEY.md §2.1, §5.5):
services create named subgroups, counters/gauges/histograms register by
name, and encoders walk the tree. One process-global root; tests make
private roots.

The port's own copy of ``ydb_tpu/obs/counters.py``.
"""

from __future__ import annotations

import bisect
import threading

from ydb_tpu_torch.analysis import sanitizer


class Counter:
    __slots__ = ("value", "_lock")

    def __init__(self):
        self.value = 0
        self._lock = threading.Lock()

    def inc(self, by: int = 1):
        with self._lock:
            self.value += by

    def set(self, value):
        with self._lock:
            self.value = value


class Histogram:
    """Fixed-bucket histogram (exponential bounds by default).

    Default bounds reach DOWN to one microsecond: warm device ops run
    well under a millisecond, and the old 1ms floor quantized every
    sub-ms p50 up to it. ``percentile`` interpolates linearly WITHIN
    the winning bucket (the Prometheus ``histogram_quantile``
    convention) instead of answering with the bucket edge."""

    def __init__(self, bounds: tuple = ()):
        self.bounds = tuple(bounds) or tuple(
            1e-6 * (4 ** i) for i in range(16))  # 1us .. ~1074s
        self.buckets = [0] * (len(self.bounds) + 1)
        self.count = 0
        self.total = 0.0
        self._lock = threading.Lock()

    def observe(self, value: float):
        with self._lock:
            idx = bisect.bisect_left(self.bounds, value)
            self.buckets[idx] += 1
            self.count += 1
            self.total += value

    def percentile(self, q: float) -> float:
        with self._lock:
            if not self.count:
                return 0.0
            target = q * self.count
            acc = 0
            for i, n in enumerate(self.buckets):
                if not n:
                    continue
                acc += n
                if acc >= target:
                    if i >= len(self.bounds):
                        # overflow bucket: no finite upper edge to
                        # interpolate toward — report its lower edge
                        return self.bounds[-1] if self.bounds else 0.0
                    lo = self.bounds[i - 1] if i else 0.0
                    hi = self.bounds[i]
                    frac = (target - (acc - n)) / n
                    return lo + (hi - lo) * frac
            return self.bounds[-1] if self.bounds else 0.0


class CounterGroup:
    def __init__(self, labels: dict | None = None):
        self.labels = dict(labels or {})
        # registry dicts are sanitizer-tracked under
        # YDB_TPU_TORCH_TSAN=1 (services register counters from conveyor
        # workers + API threads concurrently)
        self._children = sanitizer.share(
            {}, f"counters.{id(self):x}.children")
        self._counters = sanitizer.share(
            {}, f"counters.{id(self):x}.counters")
        self._histograms = sanitizer.share(
            {}, f"counters.{id(self):x}.histograms")
        self._lock = sanitizer.make_lock(f"counters.{id(self):x}.lock")

    def group(self, **labels) -> "CounterGroup":
        key = tuple(sorted(labels.items()))
        with self._lock:
            child = self._children.get(key)
            if child is None:
                merged = dict(self.labels, **labels)
                child = self._children[key] = CounterGroup(merged)
            return child

    def counter(self, name: str) -> Counter:
        with self._lock:
            c = self._counters.get(name)
            if c is None:
                c = self._counters[name] = Counter()
            return c

    def histogram(self, name: str, bounds: tuple = ()) -> Histogram:
        with self._lock:
            h = self._histograms.get(name)
            if h is None:
                h = self._histograms[name] = Histogram(bounds)
            return h

    # ---- encoding ----

    def _label_str(self) -> str:
        if not self.labels:
            return ""
        inner = ",".join(f'{k}="{v}"'
                         for k, v in sorted(self.labels.items()))
        return "{" + inner + "}"

    def encode_prometheus(self) -> str:
        lines = []
        self._encode(lines)
        return "\n".join(lines) + ("\n" if lines else "")

    def _encode(self, lines: list):
        ls = self._label_str()
        # registry iteration must share the writers' lock: a service
        # registering a counter mid-scrape would resize the dict under
        # the encoder (dynamic race found by the TSAN stress suite).
        # Child encoding happens OUTSIDE it — parent->child is the only
        # acquisition order, and values render from a stable snapshot.
        with self._lock:
            counters = sorted(self._counters.items())
            hists = sorted(self._histograms.items())
            children = list(self._children.values())
        for name, c in counters:
            lines.append(f"{name}{ls} {c.value}")
        for name, h in hists:
            lines.append(f"{name}_count{ls} {h.count}")
            lines.append(f"{name}_sum{ls} {h.total}")
            acc = 0
            bounds = [str(b) for b in h.bounds] + ["+Inf"]
            for bound, n in zip(bounds, h.buckets):
                acc += n
                le = dict(self.labels, le=bound)
                inner = ",".join(
                    f'{k}="{v}"' for k, v in sorted(le.items()))
                lines.append(f"{name}_bucket{{{inner}}} {acc}")
        for child in children:
            child._encode(lines)

    def snapshot(self) -> dict:
        """Flat dict for sys views / tests."""
        out = {}
        self._snap(out)
        return out

    def _snap(self, out: dict):
        prefix = ",".join(f"{k}={v}"
                          for k, v in sorted(self.labels.items()))
        with self._lock:
            counters = list(self._counters.items())
            hists = list(self._histograms.items())
            children = list(self._children.values())
        for name, c in counters:
            out[f"{name}|{prefix}"] = c.value
        for name, h in hists:
            out[f"{name}_count|{prefix}"] = h.count
        for child in children:
            child._snap(out)


_root = CounterGroup()


def root_counters() -> CounterGroup:
    return _root
