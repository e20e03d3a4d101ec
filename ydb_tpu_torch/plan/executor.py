"""Plan executor: DQ stage graph for join-bearing plans, whole-plan
fusion for the rest, the single-chip walk where neither applies.

The counterpart of ``ydb_tpu/plan/executor.py``, routing as it does
(``execute_plan``): every plan containing a join lowers to the DQ task
graph — scan stages feeding hash-partitioned channels into grace-bucket
join stages and a final aggregate — executed by credit-flow compute
actors (``kqp/dq_lower.py`` + ``dq/compute.py``). Every other plan that
is not a bare ``TableScan`` (and ``use_dq=False``, and a plan DQ does
not lower) goes to whole-plan fusion (``ssa/plan_fuse.py``: one CUDA
graph replay per statement) when ``plan_fuse.fusion_enabled()`` and the
plan is fusible (small tables, no UDF). The rest takes the walk: the
plan tree is walked bottom-up, table scans stream blocks through
compiled SSA programs (``engine/scan.py``), joins run the sort-based
kernels of ``ssa/join.py``, and transforms compile against the inferred
intermediate schema. Everything runs on the database's device (CUDA
unless ``Database.device`` names another).

Not in the port yet, each with its ROADMAP.md queue A item: zone-map
pruning, the block cache, the resident tier and the table statistics
behind DQ join sizing (item 10; fused staging reads the source's
columns directly), tracing, probes, ``StageTimer`` and the ``fuse.trace``
chaos hook (items 12 and 14), and the mesh executor (item 13).
"""

from __future__ import annotations

import dataclasses
import os

import torch

from ydb_tpu_torch.analysis.verify import check_program
from ydb_tpu_torch.blocks.block import TableBlock, concat_blocks, device_aux
from ydb_tpu_torch.blocks.dictionary import DictionarySet
from ydb_tpu_torch.chaos import deadline as statement_deadline
from ydb_tpu_torch.device import resolve_device
from ydb_tpu_torch.engine.oracle import OracleTable
from ydb_tpu_torch.engine.scan import ColumnSource, ScanExecutor
from ydb_tpu_torch.plan.nodes import (
    Concat,
    ExpandJoin,
    LookupJoin,
    PlanNode,
    TableScan,
    Transform,
)
from ydb_tpu_torch.ssa import join as join_kernels
from ydb_tpu_torch.ssa.compiler import compile_program

#: rows per block of a table scan (the reference's SQL scan block size)
SCAN_BLOCK_ROWS = 1 << 22

#: DQ is the default executor for join-bearing plans, as in the
#: reference; YDB_TPU_TORCH_DQ=0 restores the walk
DQ_ON = os.environ.get("YDB_TPU_TORCH_DQ", "1") not in ("0", "", "off")
#: tasks per scan and join stage, and rows per source block, of a DQ
#: graph (the reference's defaults)
DQ_TASKS = 2
DQ_BLOCK_ROWS = 1 << 20


@dataclasses.dataclass
class Database:
    """Named tables + shared dictionaries (one 'shard' worth).

    ``_compile_cache`` memoizes compiled Transform programs per
    (program, aliases, schema) and scan executors per (table, program).
    Ingest that extends dictionaries must call
    ``invalidate_compile_cache()`` (plan-time dictionary tables bake into
    the cached aux). ``device`` is where every block of a statement
    lives; sources may be host arrays or already on it
    (``ColumnSource.to_device``)."""

    sources: dict[str, ColumnSource]
    dicts: DictionarySet | None = None
    key_spaces: dict[str, int] | None = None
    _compile_cache: dict = dataclasses.field(default_factory=dict)
    device: "str | torch.device | None" = None

    def invalidate_compile_cache(self):
        self._compile_cache.clear()


def _materialize(source: ColumnSource, columns, dev) -> TableBlock:
    names = columns if columns is not None else source.schema.names
    blocks = list(source.blocks(block_rows=1 << 40, columns=names,
                                device=dev))
    return blocks[0] if len(blocks) == 1 else concat_blocks(blocks)


def _plan_nodes(plan: PlanNode):
    stack = [plan]
    while stack:
        n = stack.pop()
        yield n
        if isinstance(n, (LookupJoin, ExpandJoin)):
            stack += [n.probe, n.build]
        elif isinstance(n, Transform):
            stack.append(n.input)
        elif isinstance(n, Concat):
            stack += list(n.inputs)


def _partition_for_dq(src) -> list:
    """A table's scan partitions for DQ task feeding: round-robin row
    slices (``partition_source``)."""
    if isinstance(src, ColumnSource) and src.num_rows > 0:
        from ydb_tpu_torch.kqp.dq_lower import partition_source

        return partition_source(src, DQ_TASKS)
    return [src]


def _execute_plan_dq(plan: PlanNode, db: Database) -> TableBlock | None:
    """Lower to DQ stages and run on an in-process actor system, every
    block on the database's device. Returns None when the plan does not
    lower (the caller falls back to the walk)."""
    from ydb_tpu_torch.dq import compute
    from ydb_tpu_torch.kqp.dq_lower import plan_to_stages
    from ydb_tpu_torch.runtime.actors import ActorSystem

    seen: set[int] = set()
    parts: dict[str, list] = {}
    for node in _plan_nodes(plan):
        if id(node) in seen:
            # a shared subtree (CTE referenced twice) would re-lower —
            # and re-execute — once per consumer; the walk's _memo
            # executes it once, so fall back
            return None
        seen.add(id(node))
        if isinstance(node, TableScan) and node.table not in parts:
            src = db.sources.get(node.table)
            if src is None:
                return None
            parts[node.table] = _partition_for_dq(src)
    rt = ActorSystem(node=1)
    try:
        stages = plan_to_stages(plan, n_tasks=DQ_TASKS)
        handle = compute.build_stage_graph(
            stages, parts, rt, db.dicts, db.key_spaces,
            block_rows=DQ_BLOCK_ROWS, compile_cache=db._compile_cache,
            device=db.device)
    except (ValueError, NotImplementedError):
        # plan shapes that do not lower (e.g. a join-rooted plan with no
        # result Transform) keep working through the walk
        return None
    try:
        handle.start()
        rt.run()
        err = handle.collector.error
        if err is not None and "deadline" in err:
            # the graph aborted on statement-deadline expiry: surface
            # the typed cancellation, not a generic incompletion
            raise statement_deadline.StatementCancelled(err)
        if not handle.collector.done:
            raise RuntimeError("DQ stage graph did not complete")
        return handle.collector.result_block()
    finally:
        # a cancelled/aborted graph still holds spilled blobs for any
        # parked or accumulated block ids; drop them with the graph
        handle.close()


def execute_plan(plan: PlanNode, db: Database,
                 _memo: dict | None = None,
                 use_dq: bool | None = None) -> TableBlock:
    """Execute a logical plan: join-bearing plans route through the DQ
    stage graph (``use_dq=None`` follows ``DQ_ON``, on by default); the
    rest (join-free plans, shapes that do not lower, ``use_dq=False``)
    through whole-plan fusion when it is enabled, the plan is not a bare
    ``TableScan`` and it is fusible; otherwise the bottom-up walk.
    ``_memo`` dedupes shared subtrees (a CTE referenced from several
    places executes once per statement)."""
    if _memo is None:
        if (use_dq if use_dq is not None else DQ_ON) and any(
                isinstance(n, (LookupJoin, ExpandJoin))
                for n in _plan_nodes(plan)):
            out = _execute_plan_dq(plan, db)
            if out is not None:
                return out
        # whole-plan fusion: one dispatch for the whole tree when it is
        # fusible. A bare TableScan is already a single fragment — the
        # walk's streaming scan stays.
        from ydb_tpu_torch.ssa import plan_fuse

        if plan_fuse.fusion_enabled() and not isinstance(plan, TableScan):
            out = _execute_plan_fused(plan, db)
            if out is not None:
                return out
        _memo = {}
    hit = _memo.get(id(plan))
    if hit is not None:
        return hit
    out = _execute_node(plan, db, _memo)
    _memo[id(plan)] = out
    return out


def _scan_node(plan: TableScan, db: Database, dev) -> TableBlock:
    src = db.sources[plan.table]
    key = (plan.table, plan.program)
    ex = db._compile_cache.get(key)
    if ex is None:
        ex = ScanExecutor(
            plan.program, src, block_rows=SCAN_BLOCK_ROWS, device=dev,
            key_spaces=db.key_spaces,
        ).detach()  # cache compiled state, not the source
        db._compile_cache[key] = ex
    return ex.run_stream(src.blocks(SCAN_BLOCK_ROWS, ex.read_cols,
                                    device=dev))


def _stage_fused_site(site, db: Database, fused) -> TableBlock:
    """One fused scan site's rows at its shape-class capacity, on the
    plan's device. On CUDA they are copied straight into the fused plan's
    static input block, which is returned (a host table is one copy from
    the host, a table held on the card one copy on the card); elsewhere
    they make a fresh block. A source that is not a ``ColumnSource`` (a
    block stream, as the storage tiers of ROADMAP.md item 10 give)
    streams its blocks, which ``fit_blocks`` merges and pads."""
    from ydb_tpu_torch.ssa import plan_fuse

    src = db.sources[site.table]
    dev = fused.device
    if not isinstance(src, ColumnSource):
        blocks = tuple(src.blocks(SCAN_BLOCK_ROWS, site.read_cols,
                                  device=dev))
        return plan_fuse.fit_blocks(blocks, site.capacity)
    arrays = {m: src.columns[m] for m in site.read_cols}
    validity = None
    if src.validity:
        validity = {m: src.validity[m] for m in site.read_cols
                    if m in src.validity}
    if dev.type == "cuda":
        return fused.stage_into(site.key, arrays, validity, src.num_rows)
    return TableBlock.from_numpy(arrays, site.in_schema, validity,
                                 capacity=site.capacity, device=dev)


def _run_fused(fused, db: Database) -> TableBlock:
    """Stage every scan site, dispatch the fused plan once, and handle
    expand-join overflow: grow the capacity (the cached plan keeps it for
    later statements) and dispatch again over the same staged inputs,
    which no dispatch writes. The plan's lock is held from staging to
    the result, so no other statement restages its inputs between."""
    with fused.lock:
        inputs = {s.key: _stage_fused_site(s, db, fused)
                  for s in fused.sites}
        while True:
            # cooperative cancellation between (uninterruptible) fused
            # dispatches: a statement past its deadline stops here
            statement_deadline.check_current("fused dispatch")
            out, totals = fused.run(inputs)
            over = fused.overflowed(totals)
            if not over:
                return out
            for j in over:
                fused.grow(j, totals[j])


def _execute_plan_fused(plan: PlanNode, db: Database) -> TableBlock | None:
    """Whole-plan fused path (``ssa/plan_fuse.py``): one dispatch per
    statement over one FusedPlan per (plan fingerprint, shape class),
    cached in ``db._compile_cache``. Returns None when the plan is not
    fusible (the caller falls back to the walk)."""
    from ydb_tpu_torch.ssa import plan_fuse

    sig = plan_fuse.plan_signature_cached(plan, db)
    if sig is None or not sig.sites:
        return None
    key = sig.cache_key(db)
    fused = db._compile_cache.get(key)
    if fused is None:
        try:
            fused = plan_fuse.build(sig, db)
        except plan_fuse.Unfusible:
            return None
        db._compile_cache[key] = fused
    return _run_fused(fused, db)


def _compiled_transform(plan: Transform, schema, db: Database, dev):
    """Compile a Transform program: its run function and its aux tables
    staged on ``dev``."""
    cp = compile_program(
        plan.program, schema, db.dicts, db.key_spaces,
        dict_aliases=dict(plan.dict_aliases),
    )
    return cp.run, device_aux(cp.aux, dev)


def _execute_node(plan: PlanNode, db: Database, _memo: dict) -> TableBlock:
    dev = resolve_device(db.device)
    if isinstance(plan, TableScan):
        src = db.sources[plan.table]
        if plan.program is None:
            return _materialize(src, plan.columns, dev)
        return _scan_node(plan, db, dev)
    if isinstance(plan, LookupJoin):
        probe = execute_plan(plan.probe, db, _memo)
        build = execute_plan(plan.build, db, _memo)
        return join_kernels.run_equi_join(
            probe, build, plan.probe_keys, plan.build_keys,
            kind=plan.kind, suffix=plan.suffix, payload=plan.payload,
        )
    if isinstance(plan, ExpandJoin):
        probe = execute_plan(plan.probe, db, _memo)
        build = execute_plan(plan.build, db, _memo)
        return join_kernels.run_equi_join(
            probe, build, plan.probe_keys, plan.build_keys,
            kind=plan.kind, suffix=plan.build_suffix, expand=True,
            probe_payload=plan.probe_payload,
            build_payload=plan.build_payload,
            fanout_hint=plan.fanout_hint,
        )
    if isinstance(plan, Transform):
        block = execute_plan(plan.input, db, _memo)
        key = (plan.program, plan.dict_aliases, block.schema)
        hit = db._compile_cache.get(key)
        if hit is None:
            # step-indexed diagnostics for malformed programs before any
            # lowering (compile_program re-checks)
            check_program(plan.program, block.schema)
            hit = _compiled_transform(plan, block.schema, db, dev)
            db._compile_cache[key] = hit
        run, aux = hit
        return run(block, aux)
    if isinstance(plan, Concat):
        # branches execute independently (planner guarantees identical
        # column names/types); live rows append in branch order
        return concat_blocks(
            [execute_plan(i, db, _memo) for i in plan.inputs])
    raise NotImplementedError(plan)


def to_host(block) -> OracleTable:
    """The statement's one deliberate device-to-host fetch."""
    if isinstance(block, OracleTable):
        return block
    return OracleTable.from_block(block)
