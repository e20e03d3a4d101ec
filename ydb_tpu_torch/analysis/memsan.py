"""Memory sanitizer: per-statement device-byte footprint
(YDB_TPU_TORCH_MEMSAN=1).

The runtime half of the device-memory pillar. ``devmem.py`` proves
statically that device tensors are only *created* inside budget-charging
seams; this sanitizer measures what those seams actually *allocate* per
statement — live and peak device bytes, attributed to the owning
statement (span trace-id) and to the allocation component — and enforces
a warm-statement budget: after warmup, peak device bytes within
``Budget.peak_bytes`` and **zero unbudgeted allocations**, or the
statement raises ``MemBudgetError``.

The port's own copy of ``ydb_tpu/analysis/memsan.py``. Instrumented
seams (each charges its bytes explicitly):

  ``staging``   TableBlock.from_numpy / device_aux — host->device ingest
  ``resident``  ResidentStore.promote (released on eviction/clear)
  ``stack``     FusedPlan.run_stacked member stacking (released after
                the batched dispatch returns)
  ``dispatch``  fused-plan output blocks (the clone of the static output)
  ``slabs``     engine/staging.py's pinned host slabs and their device
                blocks (one charge per slab set, released on close)
  ``graph_pool`` a CUDA graph's private pool (``FusedPlan.pool_bytes``)
                and a plan's static inputs (released when the plan
                drops its graphs)
  ``fetch``     the packed device buffer of a result fetch
                (``TableBlock.host_columns``; released after the read)

Seams wrap their device work in :func:`seam` and account the result via
:func:`charge` / :func:`release`. While armed, the raw torch creators
(``torch.zeros/ones/full/empty/stack/cat``) are patched to catch device
allocations outside any seam — those count as *unbudgeted* (the runtime
shadow of devmem rule M001). So are the tensors that host data becomes
on the device (``Tensor.to(cuda)``, ``.cuda()``, ``torch.as_tensor`` /
``torch.tensor`` onto the device, ``torch.from_numpy`` on a CPU-only
process): the counterpart of the reference's ``jax.device_put`` patch.
Those are syncsan's seams, installed while either sanitizer is armed,
and they hand their result to :func:`note_raw` (two wrappers over one
attribute would restore in the wrong order). What the reference
ignores as XLA temporaries under a trace has its torch analog in a
dispatch's working set: a compiled program's body, a join kernel or a
fused plan's ``run_all`` run eagerly under :func:`seam` (the entry
points through :func:`computing`), so their intermediate tensors stay
silent as a seam's do. Only tensors on "the device" count: CUDA when
the process has a GPU, else the CPU (the CPU tests).

The caching allocator is process-wide, so a per-statement figure comes
only from charges. ``torch.cuda.max_memory_allocated`` after
``reset_peak_memory_stats`` is a single-threaded cross-check
(``chip_smoke.py``'s phase 11).

Charges attribute to the active statement exactly like syncsan: the
beginning thread via a thread-local, conveyor workers via the inherited
obs span's trace id, anything else to the orphan window.
``end_statement`` annotates the obs span (``memsan_*`` attributes,
surfaced by EXPLAIN ANALYZE and ``QueryProfile.memsan``) and enforces
the budget. Component totals persist process-wide for the session's
``run_background`` counters.

Gates mirror ``leaksan.py``: ``YDB_TPU_TORCH_MEMSAN=1`` env,
``set_force()`` pin, ``activate()`` context manager for tests and bench.
Every entry point is a single module-global bool check while disabled,
and while disabled no creator is patched. torch is imported only when
armed.
"""

from __future__ import annotations

import functools
import os
import threading

from ydb_tpu_torch.obs import tracing

#: tri-state pin: None -> follow the env var; True/False -> forced
_FORCE: "bool | None" = None

_meta_lock = threading.Lock()
_tls = threading.local()


def enabled() -> bool:
    if _FORCE is not None:
        return _FORCE
    return os.environ.get("YDB_TPU_TORCH_MEMSAN", "") not in ("", "0")


_ON = enabled()


def armed() -> bool:
    """Cheap inline gate for charge sites: guard ``nbytes_of`` walks
    with ``if memsan.armed():`` so the disarmed path costs one
    module-global read."""
    return _ON


class MemBudgetError(AssertionError):
    """A warm statement exceeded its device-memory budget."""


class Budget:
    __slots__ = ("peak_bytes", "warmup")

    def __init__(self, peak_bytes: "int | None" = None,
                 warmup: int = 1):
        self.peak_bytes = peak_bytes
        self.warmup = warmup


_budget: "Budget | None" = None
_warm_seen: dict = {}  # label -> statements ended (warmup tracking)


class Statement:
    """Byte ledger for one statement (one ``begin``/``end`` pair)."""

    __slots__ = ("label", "trace_id", "span", "live", "peak",
                 "charges", "unbudgeted", "unbudgeted_bytes",
                 "by_component", "_lock")

    def __init__(self, label: str, trace_id: "str | None"):
        self.label = label
        self.trace_id = trace_id
        self.span = tracing.current_span()
        self.live = 0
        self.peak = 0
        self.charges = 0
        self.unbudgeted = 0
        self.unbudgeted_bytes = 0
        self.by_component: dict = {}
        self._lock = threading.Lock()

    def note_charge(self, nbytes: int, component: str,
                    budgeted: bool = True) -> None:
        with self._lock:
            self.live += nbytes
            self.peak = max(self.peak, self.live)
            self.charges += 1
            self.by_component[component] = \
                self.by_component.get(component, 0) + nbytes
            if not budgeted:
                self.unbudgeted += 1
                self.unbudgeted_bytes += nbytes

    def note_release(self, nbytes: int) -> None:
        with self._lock:
            self.live -= nbytes

    def snapshot(self) -> dict:
        with self._lock:
            return {"live": self.live, "peak": self.peak,
                    "charges": self.charges,
                    "unbudgeted": self.unbudgeted,
                    "unbudgeted_bytes": self.unbudgeted_bytes,
                    "by_component": dict(self.by_component)}


_by_trace: dict = {}       # trace_id -> Statement
_orphans = Statement("<orphan>", None)

#: process-wide per-component ledger (the session's devmem counters):
#: component -> {live, peak, charges, releases, evictions}
_components: dict = {}
_global_live = 0
_global_peak = 0


def _resolve() -> "Statement | None":
    st = getattr(_tls, "stat", None)
    if st is not None:
        return st
    span = tracing.current_span()
    if span is not None:
        st = _by_trace.get(span.trace_id)
        if st is not None:
            return st
    return _orphans


def _component_note(component: str, *, nbytes: int = 0,
                    release: int = 0, evicted: bool = False) -> None:
    global _global_live, _global_peak
    with _meta_lock:
        c = _components.get(component)
        if c is None:
            c = _components[component] = {
                "live": 0, "peak": 0, "charges": 0, "releases": 0,
                "evictions": 0}
        if nbytes:
            c["live"] += nbytes
            c["peak"] = max(c["peak"], c["live"])
            c["charges"] += 1
            _global_live += nbytes
            _global_peak = max(_global_peak, _global_live)
        if release:
            c["live"] -= release
            c["releases"] += 1
            _global_live -= release
            if evicted:
                c["evictions"] += 1


# ---------------- charge / release ----------------


class Ticket:
    """One live charge; :func:`release` returns its bytes."""

    __slots__ = ("nbytes", "component", "owner", "stat", "closed")

    def __init__(self, nbytes: int, component: str, owner, stat):
        self.nbytes = nbytes
        self.component = component
        self.owner = owner
        self.stat = stat
        self.closed = False


def nbytes_of(tree) -> int:
    """Total bytes of the tensors in ``tree``: a tensor, a
    ``TableBlock`` (every column's data and validity, and its length),
    or a list, tuple or dict of them (0 for anything else)."""
    if hasattr(tree, "element_size") and hasattr(tree, "numel"):
        return int(tree.element_size() * tree.numel())
    cols = getattr(tree, "columns", None)
    if isinstance(cols, dict) and hasattr(tree, "length"):
        return nbytes_of(tree.length) + sum(
            nbytes_of(c.data) + nbytes_of(c.validity)
            for c in cols.values())
    if isinstance(tree, dict):
        return sum(nbytes_of(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(nbytes_of(v) for v in tree)
    return 0


def charge(nbytes: int, component: str,
           owner=None) -> "Ticket | None":
    """Account ``nbytes`` of device memory to the active statement and
    the process-wide component ledger. Returns None (and counts
    nothing) while the sanitizer is off; the matching free calls
    :func:`release` on whatever this returned (sites whose buffers are
    GC-owned simply never release — the bytes stay counted as the
    statement's allocation footprint, which is the budgeted quantity)."""
    if not _ON:
        return None
    nbytes = int(nbytes)
    st = _resolve()
    st.note_charge(nbytes, component, budgeted=True)
    _component_note(component, nbytes=nbytes)
    return Ticket(nbytes, component, owner, st)


def release(ticket: "Ticket | None", *, evicted: bool = False) -> None:
    """Return a charge's bytes (None-safe and idempotent, so
    disabled-path and retry call sites stay branch-free). ``evicted``
    marks budget-valve frees (the component's eviction count)."""
    if ticket is None or ticket.closed:
        return
    ticket.closed = True
    ticket.stat.note_release(ticket.nbytes)
    _component_note(ticket.component, release=ticket.nbytes,
                    evicted=evicted)


# ---------------- seams + allocator patches ----------------


class _Seam:
    """Marks "inside a budget-charging seam" on this thread: patched
    allocators under it stay silent (the seam charges the authoritative
    total; wrapper-counting the constituent allocations would double
    count)."""

    __slots__ = ()

    def __enter__(self):
        _tls.seam_depth = getattr(_tls, "seam_depth", 0) + 1
        return self

    def __exit__(self, *exc):
        _tls.seam_depth -= 1
        return False


class _NoopSeam:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_SEAM = _Seam()
_NOOP = _NoopSeam()


def seam() -> "object":
    """``with memsan.seam():`` — the enclosed device tensors belong to a
    charging seam (the site charges their bytes) or to a dispatch's
    working set (a compiled program's body, a join kernel, ``run_all``:
    the torch analog of the reference's XLA temporaries under a trace).
    One bool when off."""
    return _SEAM if _ON else _NOOP


def computing(fn):
    """``fn`` run under :func:`seam` (one bool while disarmed): the
    compiled programs' and joins' entry points."""
    @functools.wraps(fn)
    def run(*args, **kwargs):
        with seam():
            return fn(*args, **kwargs)
    return run


def in_seam() -> bool:
    return getattr(_tls, "seam_depth", 0) > 0


def note_raw(result) -> None:
    """A patched creator, or one of syncsan's H2D seams, produced
    ``result`` outside any seam: a concrete device allocation no budget
    charged — the runtime shadow of devmem M001."""
    if not _ON or in_seam():
        return
    try:
        if result.device.type != _device_type:
            return  # a host scratch tensor on a GPU process
        nbytes = int(result.element_size() * result.numel())
    except Exception:
        return
    if not nbytes:
        return
    st = _resolve()
    st.note_charge(nbytes, "unbudgeted", budgeted=False)
    _component_note("unbudgeted", nbytes=nbytes)


_patched = False
_orig: dict = {}
#: the device type whose tensors count (CUDA when the process has one)
_device_type = "cpu"

#: patched creator set — deliberately DISJOINT from syncsan's patch
#: set (its H2D seams note their results here): overlapping patches
#: restore in undefined order when both sanitizers disarm, leaving a
#: stale wrapper installed
_PATCH = ("zeros", "ones", "full", "empty", "stack", "cat")


def _install() -> None:
    global _patched, _device_type
    try:
        import torch
    except Exception:
        return

    def _wrap(orig):
        def alloc(*args, **kwargs):
            r = orig(*args, **kwargs)
            note_raw(r)
            return r
        return alloc

    with _meta_lock:
        if _patched:
            return
        _device_type = "cuda" if torch.cuda.is_available() else "cpu"
        for name in _PATCH:
            _orig[name] = getattr(torch, name)
            setattr(torch, name, _wrap(_orig[name]))
        _patched = True


def _uninstall() -> None:
    global _patched
    import torch

    with _meta_lock:
        if not _patched:
            return
        for name in _PATCH:
            setattr(torch, name, _orig[name])
        _patched = False


def installed() -> bool:
    """Whether the torch creators are patched right now (syncsan's
    ``installed()`` says the same of the H2D seams)."""
    return _patched


# ---------------- gates (leaksan idiom) ----------------


def refresh() -> None:
    """Re-read the gate; arm or disarm the allocator patches, and
    syncsan's H2D seams, to match."""
    global _ON
    from ydb_tpu_torch.analysis import syncsan

    with _meta_lock:
        _ON = enabled()
        on = _ON
    if on:
        _install()
    else:
        _uninstall()
    syncsan.sync_seams()


def set_force(value: "bool | None") -> None:
    """Pin the sanitizer on/off regardless of the env (tests, bench);
    ``None`` returns control to ``YDB_TPU_TORCH_MEMSAN``."""
    global _FORCE
    with _meta_lock:
        _FORCE = value
    refresh()


# honor an env set before import
if _ON:
    refresh()


# ---------------- statement lifecycle ----------------


def begin_statement(label: str,
                    trace_id: "str | None" = None,
                    span=None) -> "Statement | None":
    """Open a byte ledger for one statement. Returns None (and counts
    nothing) while the sanitizer is off. ``span`` pins the obs span the
    ledger annotates at close — callers opening the window BEFORE
    activating their root span (the session statement path) must pass
    it (the syncsan rule)."""
    if not _ON:
        return None
    st = Statement(label, trace_id)
    if span is not None:
        st.span = span
    _tls.stat = st
    if trace_id is not None:
        with _meta_lock:
            _by_trace[trace_id] = st
    return st


def _close(st: "Statement | None") -> None:
    if getattr(_tls, "stat", None) is st:
        _tls.stat = None
    if st is not None and st.trace_id is not None:
        with _meta_lock:
            _by_trace.pop(st.trace_id, None)


def discard(st: "Statement | None") -> None:
    """Drop a window without budget enforcement (error paths)."""
    _close(st)


def end_statement(st: "Statement | None", *,
                  enforce: bool = True) -> "dict | None":
    """Close the ledger: annotate the obs span with ``memsan_*``
    attributes and enforce the warm budget. Returns the byte snapshot
    (None while disabled)."""
    if st is None:
        return None
    _close(st)
    snap = st.snapshot()
    if st.span is not None:
        st.span.set(memsan_peak=snap["peak"], memsan_live=snap["live"],
                    memsan_charges=snap["charges"],
                    memsan_unbudgeted=snap["unbudgeted"])
    if enforce and _budget is not None:
        with _meta_lock:
            seen = _warm_seen.get(st.label, 0)
            _warm_seen[st.label] = seen + 1
        if seen >= _budget.warmup:
            if snap["unbudgeted"]:
                raise MemBudgetError(
                    f"statement {st.label!r} made"
                    f" {snap['unbudgeted']} device allocation(s)"
                    f" ({snap['unbudgeted_bytes']} bytes) outside any"
                    " budget-charging seam on the warm path; route the"
                    " allocation through a memsan seam or annotate the"
                    " site @analysis.budget_ok (devmem M001)")
            if _budget.peak_bytes is not None and \
                    snap["peak"] > _budget.peak_bytes:
                raise MemBudgetError(
                    f"statement {st.label!r} peaked at"
                    f" {snap['peak']} device bytes"
                    f" (budget {_budget.peak_bytes}); per-component:"
                    f" {snap['by_component']}")
    return snap


def set_budget(peak_bytes: "int | None" = None,
               warmup: int = 1) -> None:
    """Arm the warm-statement budget: statements past ``warmup`` (per
    label) must stay within ``peak_bytes`` and make zero unbudgeted
    allocations."""
    global _budget
    with _meta_lock:
        _budget = (peak_bytes if isinstance(peak_bytes, Budget)
                   else Budget(peak_bytes=peak_bytes, warmup=warmup))
        _warm_seen.clear()


def clear_budget() -> None:
    global _budget
    with _meta_lock:
        _budget = None
        _warm_seen.clear()


# ---------------- surfaces ----------------


def totals() -> dict:
    """Aggregate ledger across live windows + orphans (bench)."""
    agg = _orphans.snapshot()
    agg.pop("by_component", None)
    with _meta_lock:
        stats = list(_by_trace.values())
    for st in stats:
        snap = st.snapshot()
        for k in ("live", "peak", "charges", "unbudgeted",
                  "unbudgeted_bytes"):
            agg[k] += snap[k]
    return agg


def component_totals() -> dict:
    """Process-wide per-component byte ledger (the session's
    run_background devmem counters). Empty when nothing was ever
    charged."""
    with _meta_lock:
        return {k: dict(v) for k, v in _components.items()}


def global_peak() -> int:
    """Process-wide peak live device bytes across all components (the
    devmem ``global_peak_bytes`` counter)."""
    with _meta_lock:
        return _global_peak


def budget_bytes() -> "int | None":
    """The armed per-statement peak budget, if any."""
    b = _budget
    return b.peak_bytes if b is not None else None


def reset() -> None:
    """Drop all windows, budgets, component ledgers and orphan counts
    (tests)."""
    global _orphans, _global_live, _global_peak
    with _meta_lock:
        _by_trace.clear()
        _warm_seen.clear()
        _components.clear()
        _global_live = 0
        _global_peak = 0
        _orphans = Statement("<orphan>", None)
    _tls.stat = None


class activate:
    """``with memsan.activate():`` — force the sanitizer on for a scope
    regardless of the env var, starting from a clean ledger."""

    def __init__(self, budget: "Budget | None" = None):
        self._budget = budget

    def __enter__(self):
        reset()
        set_force(True)
        if self._budget is not None:
            set_budget(peak_bytes=self._budget.peak_bytes,
                       warmup=self._budget.warmup)
        return self

    def __exit__(self, *exc):
        clear_budget()
        set_force(None)
        reset()
        return False
