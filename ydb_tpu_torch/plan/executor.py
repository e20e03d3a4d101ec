"""Plan executor: DQ stage graph for join-bearing plans, single-chip
walk for the rest.

The counterpart of ``ydb_tpu/plan/executor.py`` with whole-plan fusion
off. As in the reference, every plan containing a join lowers to the DQ
task graph — scan stages feeding hash-partitioned channels into
grace-bucket join stages and a final aggregate — executed by credit-flow
compute actors (``kqp/dq_lower.py`` + ``dq/compute.py``). Join-free
plans, plans that do not lower (a CTE-shared subtree feeding two
consumers) and ``use_dq=False`` take the walk: the plan tree is walked
bottom-up, table scans stream blocks through compiled SSA programs
(``engine/scan.py``), joins run the sort-based kernels of
``ssa/join.py``, and transforms compile against the inferred
intermediate schema. Everything runs on the database's device (CUDA
unless ``Database.device`` names another).

Not in the port yet, each with its ROADMAP.md queue A item: whole-plan
fusion (item 9), zone-map pruning, the block cache and the table
statistics behind DQ join sizing (item 10), tracing and probes (items 12
and 14), and the mesh executor (item 13).
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
    stage graph (``use_dq=None`` follows ``DQ_ON``, on by default);
    join-free plans, shapes that do not lower and ``use_dq=False`` use
    the bottom-up walk. ``_memo`` dedupes shared subtrees (a CTE
    referenced from several places executes once per statement)."""
    if _memo is None:
        if (use_dq if use_dq is not None else DQ_ON) and any(
                isinstance(n, (LookupJoin, ExpandJoin))
                for n in _plan_nodes(plan)):
            out = _execute_plan_dq(plan, db)
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
