"""Logical query plan: the multi-table dataflow above SSA programs.

The reference splits a query into stages connected by channels
(dq_tasks.proto:190); each stage hosts a MiniKQL program, and joins are
stage operators (GraceJoin/MapJoin). Here the plan is a small node tree:
table scans carry pushed-down SSA programs (the kqp_olap pushdown shape,
kqp_opt_phy_olap_filter.cpp), joins pick the N:1 lookup or N:M expand
kernel, and Transform nodes run post-join SSA (aggregation/sort/having).
The executor (plan/executor.py) walks it bottom-up.

The port's copy of ``ydb_tpu/plan/nodes.py``, unchanged apart from its
imports.
"""

from __future__ import annotations

import dataclasses
from typing import Union

from ydb_tpu_torch.ssa.program import Program


@dataclasses.dataclass(frozen=True)
class TableScan:
    table: str
    program: Program | None = None  # pushed-down filter/project/partial-agg
    columns: tuple[str, ...] | None = None  # projection when no program


@dataclasses.dataclass(frozen=True)
class LookupJoin:
    """N:1 equi-join (build keys unique): every TPC-H FK->PK join."""

    probe: "PlanNode"
    build: "PlanNode"
    probe_keys: tuple[str, ...]
    build_keys: tuple[str, ...]
    payload: tuple[str, ...] = ()  # build columns carried to output
    kind: str = "inner"  # inner | left | semi | anti
    suffix: str = ""


@dataclasses.dataclass(frozen=True)
class ExpandJoin:
    """N:M equi-join via static-capacity expansion (inner | left)."""

    probe: "PlanNode"
    build: "PlanNode"
    probe_keys: tuple[str, ...]
    build_keys: tuple[str, ...]
    probe_payload: tuple[str, ...]
    build_payload: tuple[str, ...]
    fanout_hint: float = 4.0
    build_suffix: str = ""
    kind: str = "inner"


@dataclasses.dataclass(frozen=True)
class Transform:
    input: "PlanNode"
    program: Program
    # (renamed_column -> source column) pairs: string columns renamed by
    # join suffixing / derived-table aliasing still resolve their
    # dictionaries at compile time
    dict_aliases: tuple[tuple[str, str], ...] = ()


@dataclasses.dataclass(frozen=True)
class Concat:
    """UNION ALL: inputs produce identical column sets; rows append.

    The reference's Extend/UnionAll expression node
    (yql/essentials/core/type_ann/type_ann_list.cpp); here each input
    executes independently and the blocks concatenate."""

    inputs: tuple["PlanNode", ...]


PlanNode = Union[TableScan, LookupJoin, ExpandJoin, Transform, Concat]


def format_plan(plan: PlanNode, indent: int = 0) -> str:
    """Human-readable physical plan (EXPLAIN output; the reference
    renders its plans via kqp query plan JSON — this is the compact
    text form)."""
    pad = "  " * indent

    def prog_summary(program) -> str:
        if program is None:
            return ""
        from ydb_tpu_torch.ssa.program import (
            AssignStep, FilterStep, GroupByStep, ProjectStep, SortStep,
        )

        bits = []
        n_filters = sum(
            1 for s in program.steps if isinstance(s, FilterStep))
        n_assigns = sum(
            1 for s in program.steps if isinstance(s, AssignStep))
        if n_filters:
            bits.append(f"filters={n_filters}")
        if n_assigns:
            bits.append(f"assigns={n_assigns}")
        for s in program.steps:
            if isinstance(s, GroupByStep):
                bits.append(
                    f"group_by[keys={list(s.keys)}, "
                    f"aggs={len(s.aggs)}]")
            elif isinstance(s, SortStep) and (s.keys or s.limit):
                lim = f", limit={s.limit}" if s.limit is not None else ""
                bits.append(f"sort[{list(s.keys)}{lim}]")
            elif isinstance(s, ProjectStep):
                bits.append(f"project={list(s.names)}")
        return ", ".join(bits)

    if isinstance(plan, TableScan):
        return (f"{pad}TableScan {plan.table}"
                + (f" ({prog_summary(plan.program)})"
                   if plan.program is not None else ""))
    if isinstance(plan, LookupJoin):
        head = (f"{pad}LookupJoin[{plan.kind}] "
                f"{list(plan.probe_keys)} = {list(plan.build_keys)}"
                + (f" payload={list(plan.payload)}" if plan.payload
                   else ""))
        return "\n".join([
            head,
            format_plan(plan.probe, indent + 1),
            format_plan(plan.build, indent + 1),
        ])
    if isinstance(plan, ExpandJoin):
        head = (f"{pad}ExpandJoin[{plan.kind}] "
                f"{list(plan.probe_keys)} = {list(plan.build_keys)}")
        return "\n".join([
            head,
            format_plan(plan.probe, indent + 1),
            format_plan(plan.build, indent + 1),
        ])
    if isinstance(plan, Transform):
        return "\n".join([
            f"{pad}Transform ({prog_summary(plan.program)})",
            format_plan(plan.input, indent + 1),
        ])
    if isinstance(plan, Concat):
        return "\n".join(
            [f"{pad}Concat[{len(plan.inputs)}]"]
            + [format_plan(i, indent + 1) for i in plan.inputs])
    return f"{pad}{plan!r}"
