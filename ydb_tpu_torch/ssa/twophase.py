"""Two-phase aggregation: split a Program at its GROUP BY.

The reference computes grouped aggregates in two phases — per-input partial
states (BlockCombineHashed, mkql_block_agg.cpp:1637) merged after a shuffle
(BlockMergeFinalizeHashed, :1655). The port's copy of
``ydb_tpu/ssa/twophase.py``; the same split serves:

  * multi-block scans: each block produces a small partial block; partials
    concat + finalize (ydb_tpu_torch.engine.scan)
  * mesh parallelism: per-device partials merge via collectives
  * DQ-style stage graphs: partial on scan tasks, final after HashPartition

``split(program)`` returns (partial, final):
  partial = steps before GROUP BY + a rewritten GROUP BY emitting mergeable
            states (AVG -> SUM+COUNT; COUNT -> COUNT; others unchanged)
  final   = GROUP BY over the partial columns with merge functions
            (SUM of SUMs/COUNTs, MIN of MINs, ...) + assigns restoring AVG
            + the original post-GROUP-BY steps + projection to the original
            output.
Programs without GROUP BY return (program, None): block results concat
directly (pure filter/project programs need no merge).
"""

from __future__ import annotations

from ydb_tpu_torch.ssa.ops import Agg, Op
from ydb_tpu_torch import dtypes
from ydb_tpu_torch.ssa.program import (
    AggSpec,
    AssignStep,
    Call,
    Col,
    Const,
    GroupByStep,
    Program,
    ProjectStep,
    lit,
)


def dict_aliases(partial: Program) -> dict[str, str]:
    """column -> source-column dictionary aliases for the FINAL program:
    string-valued aggregate outputs (MIN(s) AS lo) carry the source
    column's dictionary."""
    gb = partial.group_by
    if gb is None:
        return {}
    return {
        s.out_name: s.column
        for s in gb.aggs
        if s.column is not None and s.out_name != s.column
    }


def combine_of(program: Program) -> Program | None:
    """The associative merge step of a two-phase split: a program that maps
    a batch of partial-state blocks to ONE partial-state block with the
    same columns (SUM of SUMs, MIN of MINs, ...). Because it is closed
    over the partial form and associative, scans can fold partials
    incrementally (tree reduction) instead of retaining every per-block
    partial until the end — the memory-bound analog of the reference's
    streaming combiner (mkql_block_agg.cpp BlockCombineHashed)."""
    partial, final = split(program)
    if final is None:
        return None
    gb = final.steps[0]
    assert isinstance(gb, GroupByStep)
    return Program((gb,))


def split(
    program: Program, with_row_counts: bool = False
) -> tuple[Program, Program | None]:
    """``with_row_counts`` adds an implicit ``__rows`` COUNT_ALL state to
    the partial program — mesh merging needs per-slot liveness to drop dead
    group slots before finalization (the reference's parallel.dist)."""
    gb_idx = None
    for i, s in enumerate(program.steps):
        if isinstance(s, GroupByStep):
            gb_idx = i
            break
    if gb_idx is None:
        return program, None
    gb: GroupByStep = program.steps[gb_idx]

    partial_aggs: list[AggSpec] = []
    final_aggs: list[AggSpec] = []
    avg_fixups: list[AssignStep] = []
    # derived input columns some partial states aggregate over (the
    # VAR/STDDEV x^2 column); they compute just before the partial
    # group-by
    pre_assigns: list[AssignStep] = []
    _var_cols: set[str] = set()  # VAR/STDDEV state triples per column
    for spec in gb.aggs:
        if spec.func is Agg.AVG:
            s_name = f"__avg_sum_{spec.out_name}"
            c_name = f"__avg_cnt_{spec.out_name}"
            partial_aggs.append(AggSpec(Agg.SUM, spec.column, s_name))
            partial_aggs.append(AggSpec(Agg.COUNT, spec.column, c_name))
            final_aggs.append(AggSpec(Agg.SUM, s_name, s_name))
            final_aggs.append(AggSpec(Agg.SUM, c_name, c_name))
            avg_fixups.append(
                AssignStep(
                    spec.out_name,
                    Call(
                        Op.DIV,
                        Call(Op.CAST_DOUBLE, Col(s_name)),
                        Col(c_name),
                    ),
                )
            )
        elif spec.func in (Agg.COUNT, Agg.COUNT_ALL):
            partial_aggs.append(spec)
            final_aggs.append(AggSpec(Agg.SUM, spec.out_name, spec.out_name))
        elif spec.func is Agg.SUM:
            partial_aggs.append(spec)
            final_aggs.append(AggSpec(Agg.SUM, spec.out_name, spec.out_name))
        elif spec.func is Agg.MIN:
            partial_aggs.append(spec)
            final_aggs.append(AggSpec(Agg.MIN, spec.out_name, spec.out_name))
        elif spec.func is Agg.MAX:
            partial_aggs.append(spec)
            final_aggs.append(AggSpec(Agg.MAX, spec.out_name, spec.out_name))
        elif spec.func is Agg.SOME:
            partial_aggs.append(spec)
            final_aggs.append(AggSpec(Agg.SOME, spec.out_name, spec.out_name))
        elif spec.func in (Agg.VAR_SAMP, Agg.STDDEV_SAMP):
            # decompose into linear states so the distributed merge is
            # a plain psum: SUM(x), SUM(x^2), COUNT(x) in VALUE units
            # (CAST_DOUBLE de-scales decimals); finalize via
            # var = (sq - sum^2/n) / (n - 1), clamped at 0, NULL for
            # n < 2 (safe_div on n-1 == 0). Known trade: the linear
            # form loses precision when |mean| >> stddev (relative
            # error ~ (mean/stddev)^2 * 2^-52) — the price of
            # psum-mergeable states; the CPU oracle deliberately uses
            # stable two-pass var so cross-checks expose that regime.
            # States are shared per SOURCE column: VAR + STDDEV over
            # the same column reuse one (sum, sq, count) triple.
            s_name = f"__var_sum_{spec.column}"
            q_name = f"__var_sq_{spec.column}"
            c_name = f"__var_cnt_{spec.column}"
            if s_name not in _var_cols:
                _var_cols.add(s_name)
                xd_name = f"__vd_{spec.column}"
                pre_assigns.append(AssignStep(
                    xd_name, Call(Op.CAST_DOUBLE, Col(spec.column))))
                pre_assigns.append(AssignStep(
                    q_name, Call(Op.MUL, Col(xd_name), Col(xd_name))))
                partial_aggs.append(AggSpec(Agg.SUM, xd_name, s_name))
                partial_aggs.append(AggSpec(Agg.SUM, q_name, q_name))
                partial_aggs.append(
                    AggSpec(Agg.COUNT, spec.column, c_name))
                for nm in (s_name, q_name, c_name):
                    final_aggs.append(AggSpec(Agg.SUM, nm, nm))
            var = Call(
                Op.DIV,
                Call(Op.SUB, Col(q_name),
                     Call(Op.DIV,
                          Call(Op.MUL, Col(s_name), Col(s_name)),
                          Col(c_name))),
                Call(Op.SUB, Col(c_name), lit(1)))
            var = Call(Op.GREATEST, var, Const(0.0, dtypes.DOUBLE))
            if spec.func is Agg.STDDEV_SAMP:
                var = Call(Op.SQRT, var)
            avg_fixups.append(AssignStep(spec.out_name, var))
        else:
            raise NotImplementedError(f"two-phase split of {spec.func}")

    if with_row_counts:
        partial_aggs.append(AggSpec(Agg.COUNT_ALL, None, "__rows"))
    partial = Program(
        program.steps[:gb_idx] + tuple(pre_assigns)
        + (GroupByStep(gb.keys, tuple(partial_aggs), gb.max_groups),)
    )
    out_names = tuple(gb.keys) + tuple(s.out_name for s in gb.aggs)
    final_steps: list = [
        GroupByStep(gb.keys, tuple(final_aggs), gb.max_groups)
    ]
    final_steps.extend(avg_fixups)
    final_steps.append(ProjectStep(out_names))
    final_steps.extend(program.steps[gb_idx + 1:])
    return partial, Program(tuple(final_steps))
