"""Static analysis and runtime sanitizers of the port: SSA verify, lint,
concurrency, lifecycle, hotpath, devmem (the port's copy of
``ydb_tpu/analysis``).

Six pillars, as in the reference:
  * ``verify`` — the typed SSA program checker every SQL→SSA lowering
    passes through before the compiler lowers it to torch operations.
  * ``lint`` — an AST linter over the Python tree. "Trace" reads "CUDA
    graph capture" here: the function ``ssa/plan_fuse.py`` hands to
    the capture (``run_all``) and every function that calls torch in
    the same module shape. L001 is a host sync inside such a function
    (``.item``, ``.cpu``, ``.tolist``, ``.numpy``, ``int()``/``bool()``
    of a tensor, ``torch.nonzero``, boolean-mask indexing), L002
    Python branching on a tensor; L003-L007 keep their meaning.
    ``python -m ydb_tpu_torch.analysis.lint``.
  * ``concurrency`` + ``sanitizer`` — lock/guard discipline over the
    threaded runtime (C001-C008), with ``device.capture_lock`` and
    ``device.work_lock`` in the lock-order graph, plus an Eraser-style
    runtime race detector (``YDB_TPU_TORCH_TSAN=1``).
  * ``lifecycle`` + ``leaksan`` — acquire/release pairing (R001-R008)
    plus a runtime leak sanitizer (``YDB_TPU_TORCH_LEAKSAN=1``) whose
    tracked handles must drain at statement end and ``Cluster.stop``.
  * ``hotpath`` + ``syncsan`` — dispatch purity. The static half walks
    the warm statement corridor from five roots (H001-H006, torch sync
    roots); the runtime half (``YDB_TPU_TORCH_SYNCSAN=1``) counts each
    statement's H2D and D2H copies, host syncs, CUDA graph captures,
    kernel builds and ``compile_program`` calls.
  * ``devmem`` + ``memsan`` — device-memory discipline. The static half
    flags tensor creation outside a budget-charging seam and the CUDA
    graph hazards (M001-M008); the runtime half
    (``YDB_TPU_TORCH_MEMSAN=1``) charges each statement's device bytes
    per component and counts allocations no seam charged.

``python -m ydb_tpu_torch.analysis`` runs all six and exits 1 on any
finding. ``sanitizer``, ``leaksan``, ``syncsan`` and ``memsan`` keep the
reference's import-time dependency set (os + threading + obs.tracing;
torch only once armed) so ``runtime/conveyor.py``, ``obs/counters.py``,
``obs/probes.py`` and ``engine/blockcache.py`` import them safely.

``host_ok`` is the hotpath escape hatch: the decorated function's host
work is deliberate (the lazy result fetch, a compile-cache miss path);
the analyzer neither reports nor descends into it, and the reason
string says why at the site. ``budget_ok`` is the devmem analog.
"""


def host_ok(reason: str):
    """Mark a function's host work as deliberate for the dispatch-
    purity analyzer (``hotpath.py``). The decorated function is
    excluded from the warm-path walk; ``reason`` says why the host
    boundary crossing is intentional (e.g. "lazy result fetch")."""

    def mark(fn):
        fn.__host_ok__ = reason
        return fn

    return mark


def budget_ok(reason: str):
    """Mark a function's device allocations as deliberately budgeted
    or bounded for the device-memory analyzer (``devmem.py``). The
    decorated function is excluded from the M-rule scan; ``reason``
    names the budget that covers it (e.g. "charged to the resident
    ledger")."""

    def mark(fn):
        fn.__budget_ok__ = reason
        return fn

    return mark


from ydb_tpu_torch.analysis.diagnostics import (  # noqa: F401,E402
    Diagnostic,
    PlanError,
    VerificationError,
)
