"""Sync sanitizer: per-statement host-boundary counters
(YDB_TPU_TORCH_SYNCSAN=1).

The runtime half of the dispatch-purity pillar. ``hotpath.py`` proves
statically that no host work is *written* on the warm path; this
sanitizer counts what actually *crosses* the host boundary per
statement — H2D copies, D2H copies, blocking syncs, CUDA graph
captures, kernel builds and ``compile_program`` calls — and enforces a
warm-statement budget: after warmup, **zero captures, builds and
compiles** and a bounded sync count, or the statement raises
``SyncBudgetError``.

The port's own copy of ``ydb_tpu/analysis/syncsan.py``, with torch
seams. "The device" is where this process keeps its tensors: CUDA when
the process has a GPU, else the CPU (the CPU tests run the port there,
as the reference's CPU tests run jax on the CPU backend). Seams patched
while armed (restored on disarm):

  ``Tensor.item`` / ``.tolist`` / ``.numpy``  one D2H copy + one sync
                              (a tensor on the device becomes a host
                              value)
  ``Tensor.cpu`` / ``.to(cpu)``  one D2H copy + one sync from a CUDA
                              tensor (a ``non_blocking`` copy: no sync)
  ``Tensor.to(cuda)`` / ``.cuda`` / ``.copy_``  one H2D copy from a host
                              tensor into a CUDA one
  ``torch.from_numpy`` / ``torch.as_tensor`` / ``torch.tensor``  one
                              H2D copy when host data becomes a tensor
                              on the device
  ``torch.cuda.synchronize``, ``Event.synchronize``,
  ``Stream.synchronize``      one blocking sync

A deliberate batched fetch (``TableBlock.host_columns`` through
``blocks.block._fetch``) runs under :func:`batched`: one D2H copy and
one sync for the whole fetch, however many tensors it reads, as the
reference counts one ``jax.device_get`` of a whole block.

Method patches miss implicit syncs (boolean-mask indexing, ``nonzero``,
``unique``, ``int(t)``, ``bool(t)``). On CUDA the sanitizer therefore
also sets ``torch.cuda.set_sync_debug_mode("warn")`` (saved and
restored) and counts each "called a synchronizing CUDA operation"
warning as a ``debug_syncs`` count, reported apart from the seams'
``syncs``. ``warnings.catch_warnings`` is not thread-safe, so the
warnings reach the counters through a ``showwarning`` hook that
resolves the statement of the thread that raised them. ``plan_fuse``'s
warm-up sets the mode to ``"error"`` and restores it, so its syncs
raise there and are never counted; disarming leaves an ``"error"``
mode that a capture set in place. On the CPU the debug mode sees
nothing, so CPU runs count the explicit seams only.

Compile events have no seam: the port never calls ``jax.jit``. Its
sites report them with :func:`count` (``captures`` from
``FusedPlan._capture``, ``builds`` from ``cuda_kernels.build``,
``compiles`` from ``compile_program``); the reference's "zero warm
compiles" becomes zero of all three.

The H2D seams also hand the device tensor they made to memsan
(``memsan.note_raw``): a copy onto the device outside a memsan seam is
an unbudgeted allocation, the torch counterpart of the reference
memsan's ``jax.device_put`` patch. One patch serves both sanitizers (two
wrappers over one attribute would restore in the wrong order), so the
seams are installed while syncsan *or* memsan is armed
(:func:`sync_seams`); each counts only while it is armed itself. The
CUDA sync debug mode follows syncsan alone.

Counters attribute to the active statement: the thread that called
``begin_statement`` resolves via a thread-local; conveyor workers
resolve via the obs span they inherited (``tracing.wrap_current``) and
the trace-id registry; anything else lands in the orphan totals.
``end_statement`` annotates the obs span (``syncsan_*`` attributes,
surfaced by EXPLAIN ANALYZE and ``QueryProfile.syncsan``) and enforces
the budget.

Gates mirror ``leaksan.py``: ``YDB_TPU_TORCH_SYNCSAN=1`` env,
``set_force()`` pin, ``activate()`` context manager for tests and
bench. All functions are None-safe no-ops while disabled, and while
disabled no seam is patched. torch is imported only when armed.
"""

from __future__ import annotations

import os
import threading

from ydb_tpu_torch.analysis import memsan
from ydb_tpu_torch.obs import tracing

#: the text of torch's sync debug-mode warning
SYNC_WARNING = "called a synchronizing CUDA operation"

#: tri-state pin: None -> follow the env var; True/False -> forced
_FORCE: "bool | None" = None

_meta_lock = threading.Lock()
_tls = threading.local()

#: the counters of one statement, in report order
FIELDS = ("h2d", "d2h", "syncs", "debug_syncs", "captures", "builds",
          "compiles")


def enabled() -> bool:
    if _FORCE is not None:
        return _FORCE
    return os.environ.get("YDB_TPU_TORCH_SYNCSAN", "") not in ("", "0")


_ON = enabled()


class SyncBudgetError(AssertionError):
    """A warm statement exceeded its host-boundary budget."""


class Budget:
    """``compiles`` bounds captures, builds and ``compile_program`` calls
    each; ``syncs`` bounds the seams' syncs (the debug mode's count is
    reported, not budgeted: the CPU cannot see it)."""

    __slots__ = ("compiles", "syncs", "warmup")

    def __init__(self, compiles: int = 0, syncs: "int | None" = None,
                 warmup: int = 1):
        self.compiles = compiles
        self.syncs = syncs
        self.warmup = warmup


_budget: "Budget | None" = None
_warm_seen: dict = {}  # label -> statements ended (warmup tracking)


class Statement:
    """Counters for one statement (one ``begin``/``end`` pair)."""

    __slots__ = ("label", "trace_id", "span", "counts", "_lock")

    def __init__(self, label: str, trace_id: "str | None"):
        self.label = label
        self.trace_id = trace_id
        self.span = tracing.current_span()
        self.counts = dict.fromkeys(FIELDS, 0)
        self._lock = threading.Lock()

    def note(self, **counts) -> None:
        with self._lock:
            for k, v in counts.items():
                self.counts[k] += v

    def snapshot(self) -> dict:
        with self._lock:
            return dict(self.counts)


_by_trace: dict = {}       # trace_id -> Statement
_orphans = Statement("<orphan>", None)


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


def _note(**counts) -> None:
    if not _ON:
        return
    st = _resolve()
    if st is not None:
        st.note(**counts)


def count(**counts) -> None:
    """Report compile events (``captures=1``, ``builds=1``,
    ``compiles=1``) to the active statement. One bool while disarmed."""
    if _ON:
        _note(**counts)


def _seam(**counts) -> None:
    """A patched seam's count, unless a batched fetch owns it."""
    if not getattr(_tls, "batched", 0):
        _note(**counts)


class _Batched:
    """One deliberate batched fetch: counts one D2H copy and one sync,
    and mutes the seams it crosses inside (the reference's
    ``jax.device_get`` of a whole block: one round trip, one count)."""

    __slots__ = ()

    def __enter__(self):
        _note(d2h=1, syncs=1)
        _tls.batched = getattr(_tls, "batched", 0) + 1
        return self

    def __exit__(self, *exc):
        _tls.batched -= 1
        return False


class _Noop:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_BATCHED = _Batched()
_NOOP = _Noop()


def batched() -> "object":
    """``with syncsan.batched():`` around a fetch that moves many
    tensors to the host in one go (``blocks.block._fetch``). One bool
    while disarmed."""
    return _BATCHED if _ON else _NOOP


# ---------------- seam patches ----------------

_patched = False
_orig: dict = {}
#: the device type whose tensors count as "on the device"
_device_type = "cpu"
_debug_prev: "int | None" = None
_filter = None


def _on_device(t) -> bool:
    return t.device.type == _device_type


def _target_device(args, kwargs):
    """The device a ``Tensor.to`` call moves to (None: same device)."""
    import torch

    dev = kwargs.get("device")
    if dev is None and args:
        a = args[0]
        if isinstance(a, (str, torch.device)):
            dev = a
        elif isinstance(a, torch.Tensor):
            dev = a.device
    if dev is None:
        return None
    try:
        return torch.device(dev).type
    except (RuntimeError, TypeError):
        return None


def _install() -> None:
    global _patched, _device_type
    try:
        import warnings

        import torch
    except Exception:
        return
    T = torch.Tensor
    o = _orig

    def _made(r):
        """``r`` came onto the device through an H2D seam."""
        _seam(h2d=1)
        memsan.note_raw(r)

    def item(self):
        if _on_device(self):
            _seam(d2h=1, syncs=1)
        return o["item"](self)

    def tolist(self):
        if _on_device(self):
            _seam(d2h=1, syncs=1)
        return o["tolist"](self)

    def numpy(self, *a, **k):
        if _on_device(self):
            _seam(d2h=1, syncs=1)
        return o["numpy"](self, *a, **k)

    def cpu(self, *a, **k):
        if self.device.type == "cuda":
            _seam(d2h=1, syncs=1)
        return o["cpu"](self, *a, **k)

    def to(self, *a, **k):
        tgt = _target_device(a, k)
        src = self.device.type
        if tgt is not None and tgt != src and src == "cuda":
            _seam(d2h=1, syncs=0 if k.get("non_blocking") else 1)
        r = o["to"](self, *a, **k)
        if tgt == _device_type != src:
            _made(r)
        return r

    def cuda(self, *a, **k):
        r = o["cuda"](self, *a, **k)
        if self.device.type != "cuda":
            _made(r)
        return r

    def copy_(self, src, *a, **k):
        if isinstance(src, T) and src.device.type != self.device.type:
            if self.device.type == "cuda":
                _seam(h2d=1)
            elif src.device.type == "cuda":
                _seam(d2h=1, syncs=0 if (a and a[0]) or
                      k.get("non_blocking") else 1)
        return o["copy_"](self, src, *a, **k)

    def from_numpy(a):
        r = o["from_numpy"](a)
        if _device_type == "cpu":
            _made(r)
        return r

    def _host_data(data, r):
        """Did host data become the device tensor ``r``?"""
        return _on_device(r) and not (isinstance(data, T)
                                      and _on_device(data))

    def as_tensor(data, *a, **k):
        r = o["as_tensor"](data, *a, **k)
        if _host_data(data, r):
            _made(r)
        return r

    def tensor(data, *a, **k):
        r = o["tensor"](data, *a, **k)
        if _host_data(data, r):
            _made(r)
        return r

    def cuda_synchronize(*a, **k):
        _seam(syncs=1)
        return o["cuda_synchronize"](*a, **k)

    def event_synchronize(self):
        _seam(syncs=1)
        return o["event_synchronize"](self)

    def stream_synchronize(self):
        _seam(syncs=1)
        return o["stream_synchronize"](self)

    def showwarning(message, category, filename, lineno, file=None,
                    line=None):
        if _ON and SYNC_WARNING in str(message):
            _note(debug_syncs=1)
            return None
        return o["showwarning"](message, category, filename, lineno,
                                file, line)

    with _meta_lock:
        if _patched:
            return
        _device_type = "cuda" if torch.cuda.is_available() else "cpu"
        for name, fn in (("item", item), ("tolist", tolist),
                         ("numpy", numpy), ("cpu", cpu), ("to", to),
                         ("cuda", cuda), ("copy_", copy_)):
            o[name] = getattr(T, name)
            setattr(T, name, fn)
        for name, fn in (("from_numpy", from_numpy),
                         ("as_tensor", as_tensor), ("tensor", tensor)):
            o[name] = getattr(torch, name)
            setattr(torch, name, fn)
        o["cuda_synchronize"] = torch.cuda.synchronize
        torch.cuda.synchronize = cuda_synchronize
        o["event_synchronize"] = torch.cuda.Event.synchronize
        torch.cuda.Event.synchronize = event_synchronize
        o["stream_synchronize"] = torch.cuda.Stream.synchronize
        torch.cuda.Stream.synchronize = stream_synchronize
        o["showwarning"] = warnings.showwarning
        warnings.showwarning = showwarning
        _patched = True


def _uninstall() -> None:
    global _patched
    import warnings

    import torch

    with _meta_lock:
        if not _patched:
            return
        T = torch.Tensor
        for name in ("item", "tolist", "numpy", "cpu", "to", "cuda",
                     "copy_"):
            setattr(T, name, _orig[name])
        for name in ("from_numpy", "as_tensor", "tensor"):
            setattr(torch, name, _orig[name])
        torch.cuda.synchronize = _orig["cuda_synchronize"]
        torch.cuda.Event.synchronize = _orig["event_synchronize"]
        torch.cuda.Stream.synchronize = _orig["stream_synchronize"]
        warnings.showwarning = _orig["showwarning"]
        _patched = False


def _debug_mode(on: bool) -> None:
    """Put the CUDA sync debug mode at "warn" (``on``, on a CUDA process)
    or give back the mode it replaced."""
    global _debug_prev, _filter
    if not on and _debug_prev is None and _filter is None:
        return
    import warnings

    import torch

    with _meta_lock:
        if on and _debug_prev is None and torch.cuda.is_available():
            # every sync warns (the default action shows a location
            # once); the filter goes again on disarm
            warnings.filterwarnings("always", message=".*" + SYNC_WARNING)
            _filter = warnings.filters[0]
            _debug_prev = torch.cuda.get_sync_debug_mode()
            if _debug_prev == 0:
                torch.cuda.set_sync_debug_mode("warn")
        elif not on:
            if _filter is not None:
                if _filter in warnings.filters:
                    warnings.filters.remove(_filter)
                    warnings._filters_mutated()
                _filter = None
            if _debug_prev is not None:
                # a capture's "error" stays: its owner restores it
                if torch.cuda.get_sync_debug_mode() == 1:
                    torch.cuda.set_sync_debug_mode(_debug_prev)
                _debug_prev = None


def installed() -> bool:
    """Whether the torch seams are patched right now."""
    return _patched


def sync_seams() -> None:
    """Patch the torch seams while syncsan or memsan is armed, restore
    them when neither is; the debug mode follows syncsan alone."""
    if _ON or memsan.armed():
        _install()
    else:
        _uninstall()
    _debug_mode(_ON and _patched)


# ---------------- gates (leaksan idiom) ----------------


def refresh() -> None:
    """Re-read the gate; arm or disarm the seams to match."""
    global _ON
    with _meta_lock:
        _ON = enabled()
    # the seam patchers take the lock themselves (their idempotence
    # checks run under it); racing refreshes converge on the last gate
    sync_seams()


def set_force(value: "bool | None") -> None:
    """Pin the sanitizer on/off regardless of the env (tests, bench);
    ``None`` returns control to ``YDB_TPU_TORCH_SYNCSAN``."""
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
    """Open a counting window for one statement. Returns None (and
    counts nothing) while the sanitizer is off. ``span`` pins the obs
    span the counters annotate at close — callers opening the window
    BEFORE activating their root span (the session statement path)
    must pass it, else ``current_span()`` is still the caller's
    parent (or None) and the ``syncsan_*`` attrs land elsewhere."""
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
    """Close the window: annotate the obs span with ``syncsan_*``
    attributes and enforce the warm budget. Returns the counter
    snapshot (None while disabled)."""
    if st is None:
        return None
    _close(st)
    snap = st.snapshot()
    if st.span is not None:
        st.span.set(**{f"syncsan_{k}": v for k, v in snap.items()})
    if enforce and _budget is not None:
        with _meta_lock:
            seen = _warm_seen.get(st.label, 0)
            _warm_seen[st.label] = seen + 1
        if seen >= _budget.warmup:
            for k in ("captures", "builds", "compiles"):
                if snap[k] > _budget.compiles:
                    raise SyncBudgetError(
                        f"statement {st.label!r} made {snap[k]} {k} on"
                        f" the warm path (budget {_budget.compiles}); a"
                        " compile cache is missing or its key is"
                        " unstable")
            if _budget.syncs is not None and \
                    snap["syncs"] > _budget.syncs:
                raise SyncBudgetError(
                    f"statement {st.label!r} blocked on the device"
                    f" {snap['syncs']}x (budget {_budget.syncs});"
                    " host work leaked into the dispatch loop")
    return snap


def set_budget(compiles: int = 0, syncs: "int | None" = None,
               warmup: int = 1) -> None:
    """Arm the warm-statement budget: statements past ``warmup`` (per
    label) must stay within ``compiles``/``syncs``."""
    global _budget
    with _meta_lock:
        _budget = Budget(compiles=compiles, syncs=syncs, warmup=warmup)
        _warm_seen.clear()


def clear_budget() -> None:
    global _budget
    with _meta_lock:
        _budget = None
        _warm_seen.clear()


def totals() -> dict:
    """Aggregate counters across live windows + orphans (bench)."""
    agg = _orphans.snapshot()
    with _meta_lock:
        stats = list(_by_trace.values())
    for st in stats:
        for k, v in st.snapshot().items():
            agg[k] += v
    return agg


def reset() -> None:
    """Drop all windows, budgets and orphan counts (tests)."""
    global _orphans
    with _meta_lock:
        _by_trace.clear()
        _warm_seen.clear()
        _orphans = Statement("<orphan>", None)
    _tls.stat = None


class activate:
    """``with syncsan.activate():`` — force the sanitizer on for a
    scope regardless of the env var, starting from clean counters."""

    def __init__(self, budget: "Budget | None" = None):
        self._budget = budget

    def __enter__(self):
        reset()
        set_force(True)
        if self._budget is not None:
            set_budget(compiles=self._budget.compiles,
                       syncs=self._budget.syncs,
                       warmup=self._budget.warmup)
        return self

    def __exit__(self, *exc):
        clear_budget()
        set_force(None)
        reset()
        return False
