"""Plan executor: the single-chip walk of a logical plan.

The counterpart of ``ydb_tpu/plan/executor.py`` with the reference's
``use_dq=False`` and whole-plan fusion off: the plan tree is walked
bottom-up, table scans stream blocks through compiled SSA programs
(``engine/scan.py``), joins run the sort-based kernels of
``ssa/join.py``, and transforms compile against the inferred
intermediate schema. Everything runs on the database's device (CUDA
unless ``Database.device`` names another).

Not in the port yet, each with its ROADMAP.md queue A item: the DQ stage
graph (item 8; ``use_dq=True`` raises), whole-plan fusion (item 9), zone
-map pruning, the block cache and table statistics (item 10), tracing
and probes (items 12 and 14), and the mesh executor (item 13).
"""

from __future__ import annotations

import dataclasses

import torch

from ydb_tpu_torch.analysis.verify import check_program
from ydb_tpu_torch.blocks.block import TableBlock, concat_blocks, device_aux
from ydb_tpu_torch.blocks.dictionary import DictionarySet
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


def execute_plan(plan: PlanNode, db: Database,
                 _memo: dict | None = None,
                 use_dq: bool | None = None) -> TableBlock:
    """Execute a logical plan by the bottom-up walk. ``_memo`` dedupes
    shared subtrees (a CTE referenced from several places executes once
    per statement)."""
    if use_dq:
        raise NotImplementedError(
            "the DQ stage graph is not ported yet (ROADMAP.md queue A"
            " item 8); run with use_dq=False")
    if _memo is None:
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
