"""Data-movement timeline: a bounded event ring + Chrome-trace export.

The scan pipeline spreads one query over threads — blob IO and merging
on conveyor producers, block staging (pad + H2D) beside them, device
compute on the consumer — and the per-stage *sums* (obs.probes
StageTimer, EXPLAIN ANALYZE ``stages:``) say how much time each stage
took but not WHEN: whether decode overlapped compute or serialized
behind it is invisible. This module records begin/end intervals for
every pipeline event — span stages, conveyor task wait-vs-run, blob
reads, chunk decodes, H2D staging, device dispatches — into one
process-global bounded ring, and exports them as Chrome/Perfetto
``trace_event`` JSON (``python -m ydb_tpu_torch.obs.timeline --out
trace.json``) so "did decode overlap compute?" becomes a picture.

The same intervals drive the numbers ROADMAP item 2 steers by:
``stage_occupancy`` computes per-stage busy fractions (union of a
stage's intervals over the query wall) and pairwise overlap
coefficients (|A∩B| / min(|A|, |B|)) — a movement-vs-compute
coefficient of 1.0 means the pipeline is perfectly overlapped.

Byte movement counters ride here too (always on — they are plain
counters, same cost class as ``chunks_read``): blob bytes read,
decoded bytes, staged/H2D bytes, resident-tier bytes served and
per-device shuffle bytes accumulate in a process-global table that
``kqp.session`` mirrors into the ``component="movement"`` counters on
the background cadence (rates fall out of the Prometheus scrape).

Gating: the ring is OFF by default (``YDB_TPU_TORCH_TIMELINE=1`` enables;
``TIMELINE_FORCE`` is the in-process override, same contract as
``tracing.PROFILE_FORCE``). Disabled, every record site is one flag
check + one environment lookup — kernelbench's ``--profile-overhead``
A/B asserts the disabled path stays inside the profiling budget.

The port's own copy of ``ydb_tpu/obs/timeline.py``. Byte counts come
from tensor and array metadata (``numel() * element_size()``,
``nbytes``), never from a value read off the device, so counting adds
no sync. The per-device shuffle bytes (``shuffle_bytes_dev<i>``, from
``parallel.shuffle.exchange_bytes_per_device``) come with the mesh
executor (ROADMAP.md queue A item 13b). The demo runs
on CUDA unless ``--device cpu`` asks for the CPU.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import json
import os
import threading
import time

from ydb_tpu_torch.analysis import sanitizer

#: test/bench override: True/False forces the timeline regardless of
#: the environment (same contract as tracing.PROFILE_FORCE).
TIMELINE_FORCE: "bool | None" = None

#: stage categories whose intervals feed occupancy math; "movement"
#: (read+merge+stage+decode unions) vs "compute" is the coefficient
#: ROADMAP item 2 drives toward 1.0
STAGE_CATS = ("read", "merge", "stage", "compute")
#: extra interval categories recorded alongside the stages
AUX_CATS = ("blob.read", "decode", "span", "conveyor.wait",
            "conveyor.run", "dispatch")

#: movement stages unioned against compute for the overlap coefficient
MOVEMENT_CATS = ("read", "merge", "stage", "blob.read", "decode")


def timeline_enabled() -> bool:
    """Whether pipeline events land in the ring. Default OFF — the
    timeline is a diagnosis instrument, not an always-on tax."""
    if TIMELINE_FORCE is not None:
        return TIMELINE_FORCE
    return os.environ.get("YDB_TPU_TORCH_TIMELINE", "") not in ("", "0", "off")


#: one event: a closed [start, end) interval on one thread.
Event = collections.namedtuple(
    "Event", ("name", "cat", "start", "end", "tid", "trace_id", "args"))

#: perf_counter origin for Chrome-trace microsecond timestamps — all
#: record sites share this clock (StageTimer uses it too), so exported
#: events land on one consistent axis
_EPOCH = time.perf_counter()


class TimelineRing:
    """Fixed-capacity overwrite-oldest event ring.

    Writers are conveyor workers + session threads concurrently; one
    tracked lock guards the slot array (record is two list writes, so
    the critical section stays tiny). Built at import time like the
    probe registry, so the lock is the always-on tracked variant whose
    recording self-gates per access.
    """

    def __init__(self, capacity: int | None = None, name: str = "ring"):
        if capacity is None:
            capacity = int(os.environ.get(
                "YDB_TPU_TORCH_TIMELINE_EVENTS", str(1 << 16)))
        self.capacity = max(1, int(capacity))
        self._slots: list = [None] * self.capacity
        self._n = 0
        self._tnames: dict[int, str] = {}
        self._lock = sanitizer.TrackedLock(f"timeline.{name}.lock")

    def record(self, name: str, cat: str, start: float, end: float,
               trace_id: int = 0, args: dict | None = None) -> None:
        tid = threading.get_ident()
        e = Event(name, cat, start, end, tid, trace_id, args or {})
        tname = threading.current_thread().name
        with self._lock:
            self._slots[self._n % self.capacity] = e
            self._n += 1
            if self._tnames.get(tid) != tname:
                self._tnames[tid] = tname

    def events(self) -> list:
        """Retained events, oldest first."""
        with self._lock:
            n, cap = self._n, self.capacity
            if n <= cap:
                return list(self._slots[:n])
            i = n % cap
            return self._slots[i:] + self._slots[:i]

    def thread_names(self) -> dict[int, str]:
        with self._lock:
            return dict(self._tnames)

    @property
    def recorded(self) -> int:
        """Total events ever recorded (≥ len(self))."""
        with self._lock:
            return self._n

    @property
    def dropped(self) -> int:
        """Events overwritten by the bound."""
        with self._lock:
            return max(0, self._n - self.capacity)

    def clear(self) -> None:
        with self._lock:
            self._slots = [None] * self.capacity
            self._n = 0

    def __len__(self) -> int:
        with self._lock:
            return min(self._n, self.capacity)


#: the process-global ring every instrumentation site records into
RING = TimelineRing()


def record(name: str, cat: str, start: float, end: float,
           trace_id: int = 0, **args) -> None:
    """Record one interval IF the timeline is enabled (the single
    guard every instrumentation site shares)."""
    if not timeline_enabled():
        return
    RING.record(name, cat, start, end, trace_id, args or None)


@contextlib.contextmanager
def event(name: str, cat: str, trace_id: int = 0, **args):
    """Time a block into the ring; a bare yield when disabled."""
    if not timeline_enabled():
        yield
        return
    t0 = time.perf_counter()
    try:
        yield
    finally:
        RING.record(name, cat, t0, time.perf_counter(), trace_id,
                    args or None)


def current_trace_id() -> int:
    """Trace id of the thread's active span (0 outside any trace) —
    how ring events attribute to a query without plumbing arguments."""
    from ydb_tpu_torch.obs import tracing

    sp = tracing.current_span()
    return sp.trace_id if sp is not None else 0


# ---- byte-movement counters (always on) ----

_move_lock = sanitizer.TrackedLock("timeline.movement.lock")
_movement = sanitizer.share_always({}, "timeline.movement")


def add_bytes(key: str, n: int) -> None:
    """Accumulate moved bytes under ``key`` (``blob_read_bytes``,
    ``decoded_bytes``, ``staged_bytes``, ``resident_bytes``,
    ``shuffle_bytes_dev<i>``)."""
    with _move_lock:
        _movement[key] = _movement.get(key, 0) + int(n)


def movement_snapshot() -> dict:
    """Lifetime byte totals; consumers (run_background, bench) diff
    snapshots for rates."""
    with _move_lock:
        return dict(_movement)


def reset_movement() -> None:
    with _move_lock:
        _movement.clear()


# ---- interval math ----

def merge_intervals(intervals) -> list:
    """Union of [start, end) intervals as a sorted disjoint list."""
    ivs = sorted((s, e) for s, e in intervals if e > s)
    out: list = []
    for s, e in ivs:
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


def union_seconds(intervals) -> float:
    return sum(e - s for s, e in merge_intervals(intervals))


def intersect_seconds(a, b) -> float:
    """Total overlap between two interval unions (two-pointer sweep)."""
    a, b = merge_intervals(a), merge_intervals(b)
    i = j = 0
    total = 0.0
    while i < len(a) and j < len(b):
        s = max(a[i][0], b[j][0])
        e = min(a[i][1], b[j][1])
        if e > s:
            total += e - s
        if a[i][1] <= b[j][1]:
            i += 1
        else:
            j += 1
    return total


def occupancy_from_events(events, wall: float | None = None) -> dict:
    """Per-stage busy fractions + pairwise overlap coefficients.

    ``busy[cat]`` is the union length of that category's intervals (a
    thread-overlapped stage does NOT double count); ``fraction`` is
    busy over the query wall; ``overlap["a|b"]`` is
    |A∩B| / min(|A|, |B|) for every present category pair, and
    ``overlap["movement|compute"]`` unions read+merge+stage+decode
    against compute — the serialized-pipeline detector (0.0 means blob
    IO/decode/staging fully stall compute; 1.0 means they hide behind
    it)."""
    by_cat: dict[str, list] = {}
    for e in events:
        by_cat.setdefault(e.cat, []).append((e.start, e.end))
    by_cat.pop("span", None)  # spans nest whole phases, not stages
    merged = {c: merge_intervals(iv) for c, iv in by_cat.items()}
    # ratios divide UNROUNDED union lengths (rounding busy first can
    # push a coefficient past 1.0 on microsecond-scale categories)
    busy = {c: sum(e - s for s, e in iv) for c, iv in merged.items()}
    if wall is None:
        spans = [p for iv in merged.values() for p in iv]
        wall = (max(e for _, e in spans) - min(s for s, _ in spans)
                if spans else 0.0)
    out: dict = {
        "wall_seconds": round(wall, 6),
        "busy": {c: round(b, 6) for c, b in busy.items()},
        "fraction": {c: round(b / wall, 4) if wall > 0 else 0.0
                     for c, b in busy.items()},
        "overlap": {},
    }
    cats = sorted(merged)
    for i, a in enumerate(cats):
        for b in cats[i + 1:]:
            lo = min(busy[a], busy[b])
            if lo <= 0:
                continue
            out["overlap"][f"{a}|{b}"] = round(min(
                1.0, intersect_seconds(merged[a], merged[b]) / lo), 4)
    move = [p for c in MOVEMENT_CATS for p in merged.get(c, ())]
    comp = merged.get("compute", [])
    lo = min(union_seconds(move), busy.get("compute", 0.0))
    if lo > 0:
        out["overlap"]["movement|compute"] = round(min(
            1.0, intersect_seconds(move, comp) / lo), 4)
    return out


def query_occupancy(trace_id: int, wall: float | None = None,
                    ring: TimelineRing | None = None) -> dict:
    """Occupancy for one query's ring events ({} when none landed)."""
    evs = [e for e in (ring or RING).events()
           if e.trace_id == trace_id]
    if not evs:
        return {}
    return occupancy_from_events(evs, wall)


# ---- Chrome trace_event export ----

def export_chrome_trace(events=None,
                        ring: TimelineRing | None = None) -> dict:
    """Chrome/Perfetto ``trace_event`` JSON (complete "X" events, µs
    since the process timeline epoch). Load via ui.perfetto.dev or
    chrome://tracing."""
    r = ring or RING
    if events is None:
        events = r.events()
    te = []
    for tid, tname in sorted(r.thread_names().items()):
        te.append({"name": "thread_name", "ph": "M", "pid": 0,
                   "tid": tid, "args": {"name": tname}})
    for e in events:
        args = dict(e.args)
        if e.trace_id:
            args["trace_id"] = e.trace_id
        te.append({
            "name": e.name, "cat": e.cat, "ph": "X",
            "ts": round((e.start - _EPOCH) * 1e6, 3),
            "dur": round((e.end - e.start) * 1e6, 3),
            "pid": 0, "tid": e.tid, "args": args,
        })
    return {"traceEvents": te, "displayTimeUnit": "ms"}


def summary(ring: TimelineRing | None = None) -> dict:
    """Ring state for the viewer's timeline tab: per-category event
    counts + busy seconds, bound accounting, movement byte totals."""
    r = ring or RING
    evs = r.events()
    by_cat: dict[str, list] = {}
    for e in evs:
        by_cat.setdefault(e.cat, []).append((e.start, e.end))
    return {
        "enabled": timeline_enabled(),
        "events": len(evs),
        "recorded": r.recorded,
        "dropped": r.dropped,
        "capacity": r.capacity,
        "categories": {
            c: {"events": len(iv),
                "busy_seconds": round(union_seconds(iv), 6)}
            for c, iv in sorted(by_cat.items())
        },
        "movement_bytes": movement_snapshot(),
    }


# ---- CLI: run a demo query with the timeline on, export the trace ----

def _demo(sf: float, iters: int, device="cuda") -> dict:
    """Warm TPC-H Q1 over a staged ColumnShard with the timeline forced
    on — a self-contained trace to open in Perfetto."""
    from ydb_tpu_torch.device import resolve_device
    from ydb_tpu_torch.engine.blobs import MemBlobStore
    from ydb_tpu_torch.engine.shard import ColumnShard, ShardConfig
    from ydb_tpu_torch.obs import profile as profile_mod
    from ydb_tpu_torch.workload import tpch

    device = resolve_device(device)
    data = tpch.TpchData(sf=sf, seed=5)
    li = data.tables["lineitem"]
    shard = ColumnShard(
        "timeline_demo", tpch.LINEITEM_SCHEMA, MemBlobStore(),
        dicts=data.dicts,
        config=ShardConfig(compact_portion_threshold=10 ** 9,
                           scan_block_rows=1 << 16,
                           portion_chunk_rows=1 << 14),
        device=device)
    shard.commit([shard.write(dict(li))])
    prog = tpch.q1_program()
    shard.scan(prog)  # cold: compile outside the recorded window
    holder = None
    for _ in range(max(1, iters)):
        with profile_mod.profiled("q1") as holder:
            shard.scan(prog)
    return (holder.profile.to_dict() if holder and holder.profile
            else {})


def main(argv=None) -> int:
    global TIMELINE_FORCE
    ap = argparse.ArgumentParser(
        prog="python -m ydb_tpu_torch.obs.timeline",
        description="export the pipeline timeline as Chrome-trace JSON"
                    " (runs a warm TPC-H Q1 demo unless --no-demo)")
    ap.add_argument("--out", default="trace.json",
                    help="output path for the trace_event JSON")
    ap.add_argument("--sf", type=float, default=0.01,
                    help="TPC-H scale factor for the demo query")
    ap.add_argument("--iters", type=int, default=2,
                    help="warm demo iterations recorded")
    ap.add_argument("--no-demo", action="store_true",
                    help="export whatever the ring already holds")
    ap.add_argument("--device", default="cuda",
                    help="device of the demo shard (default cuda)")
    args = ap.parse_args(argv)

    profile = {}
    if not args.no_demo:
        # single-threaded CLI entry, set before any worker spawns
        TIMELINE_FORCE = True  # ydb-lint: disable=C005
        profile = _demo(args.sf, args.iters, args.device)
    trace = export_chrome_trace()
    with open(args.out, "w") as f:
        json.dump(trace, f)
    s = summary()
    print(f"{args.out}: {len(trace['traceEvents'])} trace events "
          f"({s['dropped']} dropped by the ring bound)")
    for cat, st in s["categories"].items():
        print(f"  {cat}: {st['events']} events, "
              f"{st['busy_seconds']:.6f}s busy")
    occ = profile.get("stage_occupancy") or {}
    if occ.get("overlap"):
        print("  overlap: " + " ".join(
            f"{k}={v}" for k, v in sorted(occ["overlap"].items())))
    return 0


if __name__ == "__main__":
    import sys

    # under ``python -m`` this file executes as ``__main__`` while the
    # engine hooks import ``ydb_tpu_torch.obs.timeline`` — two module
    # objects, two rings. Dispatch to the canonical instance so the
    # force flag and the ring the demo records into are the ones the
    # export reads.
    from ydb_tpu_torch.obs import timeline as _canonical

    sys.exit(_canonical.main())
