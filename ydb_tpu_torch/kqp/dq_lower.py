"""Logical plan -> DQ stage graph: the distributed execution path for
SQL statements.

The port's own copy of ``ydb_tpu/kqp/dq_lower.py``. The reference
builds a task graph from the physical plan — scan stages feeding
hash-partition channels into join/aggregate stages and a result channel
(kqp_tasks_graph.cpp:448,778; planner kqp_planner.cpp:116). This module
is the equivalent lowering over the SAME plan nodes the single-chip
executor walks (ydb_tpu_torch.plan.nodes):

  TableScan   -> N-task stage reading table partitions, pushdown program
  Lookup/Expand joins -> both inputs hash-repartition on their join keys
                 over the channels; each task joins its grace bucket
                 device-locally (join stages, dq/compute.py run_join)
  Transform   -> two-phase split: per-block partial program on the
                 stream, final merge program at the single result task

Compared to the in-process recursive executor, joins never materialize a
whole table in one place: each join task holds 1/N of each side (the
GraceJoin memory shape), streamed in through credit-flow channels with
spill-beyond-quota.

Device-side, each stage's programs run eagerly on the graph's device
(dq/compute.py), block by block.
"""

from __future__ import annotations

from ydb_tpu_torch.dq.graph import (
    HashPartition,
    JoinSpec,
    ResultOutput,
    SourceInput,
    StageSpec,
    UnionAll,
    UnionAllInput,
)
from ydb_tpu_torch.engine.oracle import OracleTable
from ydb_tpu_torch.engine.scan import ColumnSource
from ydb_tpu_torch.plan.nodes import (
    ExpandJoin,
    LookupJoin,
    TableScan,
    Transform,
)
from ydb_tpu_torch.ssa import twophase


def _split_at_sort(program):
    """Order-preserving split of a group-less program: ORDER BY / LIMIT
    (SortStep) — or a ranking WindowStep, which needs EVERY row at
    once — and everything after it must run ONCE over the merged
    inputs, never per block — per-block evaluation + arrival-order
    concat would scramble the result. Steps before the barrier are
    row-wise (assign/filter/project) and stay in the per-block phase.
    When the barrier is a keyed top-k sort, the per-block phase ALSO
    pre-tops its block (global top-k of per-block top-ks is exact),
    bounding channel traffic the way the reference's TopSort does."""
    from ydb_tpu_torch.ssa.program import Program, SortStep, WindowStep

    steps = program.steps
    si = next((i for i, s in enumerate(steps)
               if isinstance(s, (SortStep, WindowStep))), None)
    if si is None:
        return program, None
    head = list(steps[:si])
    sort = steps[si]
    if isinstance(sort, SortStep) and sort.keys \
            and sort.limit is not None:
        head.append(sort)  # deterministic per-block pre-top-k
    partial = Program(tuple(head)) if head else None
    return partial, Program(steps[si:])


def plan_to_stages(plan, n_tasks: int = 2, estimator=None,
                   allow_swap: bool = False) -> list[StageSpec]:
    """Lower a logical plan tree to DQ stages (root must be a Transform,
    which the SQL planner guarantees).

    ``estimator(node) -> float | None`` supplies statistics-based row
    estimates (for example ``stats.cost.estimate_plan_rows`` bound to a
    statistics aggregator's TableStats). Their one consumer is
    build-side selection (``allow_swap=True``): an inner expand join
    whose "build" side is estimated much larger than its probe side
    swaps the two (a grace join should build on the SMALL side). Only
    taken when both payload column sets keep the exact same output
    names (no suffix on either role), so the stage's schema is
    unchanged; result ROW ORDER may differ, which is why the swap is
    opt-in for callers that sort or aggregate above. Expand-join output
    capacity needs no estimate: each join stage sizes its output
    exactly from its match count (``ssa/join.py:run_equi_join``).
    """
    stages: list[dict] = []  # mutable specs; frozen at the end

    def add(**kw) -> int:
        stages.append(kw)
        return len(stages) - 1

    def set_output(si: int, out) -> None:
        if stages[si]["output"] is None:
            stages[si]["output"] = out
            return
        raise ValueError(
            "stage feeds two consumers; duplicate the subtree instead")

    def est(node) -> float | None:
        if estimator is None:
            return None
        try:
            return estimator(node)
        except Exception:  # noqa: BLE001 - estimates must never fail a plan
            return None

    def lower(node) -> int:
        if isinstance(node, TableScan):
            return add(program=node.program,
                       inputs=(SourceInput(node.table),),
                       output=None, tasks=n_tasks)
        if isinstance(node, (LookupJoin, ExpandJoin)):
            probe, build = node.probe, node.build
            probe_keys = tuple(node.probe_keys)
            build_keys = tuple(node.build_keys)
            swapped = False
            p_rows, b_rows = est(probe), est(build)
            if (allow_swap and isinstance(node, ExpandJoin)
                    and node.kind == "inner" and not node.build_suffix
                    and p_rows is not None and b_rows is not None
                    and b_rows > 2 * p_rows):
                probe, build = build, probe
                probe_keys, build_keys = build_keys, probe_keys
                swapped = True
            pi = lower(probe)
            bi = lower(build)
            set_output(pi, HashPartition(probe_keys))
            set_output(bi, HashPartition(build_keys))
            if isinstance(node, LookupJoin):
                j = JoinSpec(probe_keys, build_keys,
                             payload=node.payload, kind=node.kind,
                             suffix=node.suffix)
            else:
                pp = node.probe_payload
                bp = node.build_payload
                if swapped:
                    pp, bp = bp, pp
                j = JoinSpec(probe_keys, build_keys,
                             probe_payload=pp, build_payload=bp,
                             kind=node.kind, suffix=node.build_suffix,
                             expand=True)
            return add(program=None,
                       inputs=(UnionAllInput(pi), UnionAllInput(bi)),
                       output=None, tasks=n_tasks, join=j)
        if isinstance(node, Transform):
            ii = lower(node.input)
            set_output(ii, UnionAll())
            partial, final = twophase.split(node.program)
            if final is None:
                partial, final = _split_at_sort(node.program)
            return add(program=partial, final_program=final,
                       inputs=(UnionAllInput(ii),), output=None, tasks=1,
                       dict_aliases=node.dict_aliases)
        raise NotImplementedError(node)

    root = lower(plan)
    set_output(root, ResultOutput())
    out = []
    for kw in stages:
        kw.setdefault("join", None)
        kw.setdefault("final_program", None)
        kw.setdefault("dict_aliases", ())
        out.append(StageSpec(**kw))
    return out


def partition_source(src: ColumnSource, k: int) -> list[ColumnSource]:
    """Round-robin row partitions of a table (scan-task feeding). On a
    table held on the device (``ColumnSource.to_device``) the partitions
    are strided views of its tensors, copied nothing; each block cut
    from them is made contiguous as it is cut (``TableBlock.from_numpy``),
    so only the columns a scan reads are copied, one block at a time."""
    out = []
    for s in range(k):
        cols = {n: v[s::k] for n, v in src.columns.items()}
        validity = None
        if src.validity:
            validity = {n: v[s::k] for n, v in src.validity.items()}
        out.append(ColumnSource(cols, src.schema, src.dicts, validity))
    return out


def execute_plan_dq(
    plan,
    sources: dict[str, list[ColumnSource]],
    runtime,
    dicts=None,
    key_spaces=None,
    n_tasks: int = 2,
    estimator=None,
    allow_swap: bool = False,
    **graph_kw,
) -> OracleTable:
    """Run a logical plan through the DQ stage graph on ``runtime``
    (SimRuntime or a single ActorSystem). ``sources`` maps each table to
    its partition list (see partition_source); ``estimator`` /
    ``allow_swap`` feed statistics into build-side selection
    (plan_to_stages); ``graph_kw`` goes to
    ``run_stage_graph`` (``device``, ``block_rows``, ...)."""
    from ydb_tpu_torch.dq.compute import run_stage_graph

    stages = plan_to_stages(plan, n_tasks=n_tasks, estimator=estimator,
                            allow_swap=allow_swap)
    return run_stage_graph(stages, sources, runtime, dicts, key_spaces,
                           **graph_kw)
