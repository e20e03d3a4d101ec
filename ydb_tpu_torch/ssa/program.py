"""SSA scan-program model (the port's copy of ``ydb_tpu/ssa/program.py``).

The device-native equivalent of the reference's serialized physical scan
program (ydb/core/protos/ssa.proto:19-207; TProgram/TProgramStep/TAssign
ydb/core/formats/arrow/program.h:412,313,111): an ordered list of steps —
assigns, filters, group-by, projection, sort — over named columns. The
program is *logical*; ydb_tpu_torch.ssa.compiler lowers it to one eager torch
function over a TableBlock.

Design departures from the reference, driven by static device shapes:
  * Filters do not materialize row selections; they AND into the block's
    live-row mask (late materialization). Row compaction is an explicit
    kernel applied only at block/host/shuffle boundaries.
  * String predicates (==, LIKE, IN, prefix) are `DictPredicate` leaves
    resolved at compile time against host dictionaries into small
    per-id lookup tables shipped to the device (ydb_tpu_torch.blocks.dictionary).
  * GROUP BY lowers to dense-key or sort-based segment reduction with a
    static group capacity — no dynamic hash tables on device.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Union

from ydb_tpu_torch import dtypes
from ydb_tpu_torch.ssa.ops import Agg, Op

# ---------------- expressions ----------------


@dataclasses.dataclass(frozen=True)
class Col:
    name: str


@dataclasses.dataclass(frozen=True)
class Const:
    value: Any
    type: dtypes.LogicalType


@dataclasses.dataclass(frozen=True)
class Call:
    op: Op
    args: tuple["Expr", ...]

    def __init__(self, op: Op, *args: "Expr"):
        object.__setattr__(self, "op", op)
        object.__setattr__(self, "args", tuple(args))


@dataclasses.dataclass(frozen=True)
class DictPredicate:
    """A string predicate resolved against the column dictionary at
    compile time (eq / ne / like / prefix / in_set / not_in_set)."""

    column: str
    kind: str
    pattern: Any  # bytes | str | tuple for in_set


@dataclasses.dataclass(frozen=True)
class UdfCall:
    """A registered scalar UDF applied elementwise (the UDF ABI analog,
    ydb/library/yql/public/udf; SURVEY §2.9 UDF row). ``fn`` is the
    host-side vectorized implementation (numpy arrays in/out), resolved
    from the registry at plan time and carried in the node; the torch
    lowering runs it on the host between two device operations (argument
    columns out, result back), the oracle calls it directly. NULLs:
    output row is NULL iff any argument is NULL."""

    name: str
    args: tuple["Expr", ...]
    out_type: dtypes.LogicalType
    fn: object  # Callable[[np.ndarray, ...], np.ndarray]


@dataclasses.dataclass(frozen=True)
class DictMap:
    """A string->string transform resolved against the column dictionary
    at compile time (substring etc.): builds the OUTPUT dictionary for
    ``out_column`` plus an id->id gather table shipped to the device.
    The device op is a pure int gather; the new dictionary registers in
    the shared DictionarySet so downstream group-by/sort/decode see it."""

    column: str
    kind: str       # "substr"
    args: tuple     # substr: (start_1based, length)
    out_column: str


Expr = Union[Col, Const, Call, DictPredicate, DictMap, UdfCall]


def lit(value, typ: dtypes.LogicalType | None = None) -> Const:
    if typ is None:
        if isinstance(value, bool):
            typ = dtypes.BOOL
        elif isinstance(value, int):
            typ = dtypes.INT64
        elif isinstance(value, float):
            typ = dtypes.DOUBLE
        else:
            raise TypeError(f"cannot infer literal type for {value!r}")
    return Const(value, typ)


def decimal_lit(text: str, scale: int) -> Const:
    """Decimal literal, e.g. decimal_lit('0.05', 2) -> 5 @ scale 2."""
    import decimal as pydec

    v = int(pydec.Decimal(text).scaleb(scale).to_integral_value())
    return Const(v, dtypes.decimal(scale))


# ---------------- steps ----------------


@dataclasses.dataclass(frozen=True)
class AssignStep:
    name: str
    expr: Expr


@dataclasses.dataclass(frozen=True)
class FilterStep:
    expr: Expr  # boolean; NULL counts as False (reference filter semantics)


@dataclasses.dataclass(frozen=True)
class AggSpec:
    func: Agg
    column: str | None  # None for COUNT_ALL
    out_name: str


@dataclasses.dataclass(frozen=True)
class GroupByStep:
    keys: tuple[str, ...]
    aggs: tuple[AggSpec, ...]
    # Optional static cap on distinct groups per block. Default None: the
    # sort-based path sizes its output to the block capacity (a block of N
    # rows has at most N groups), so nothing is dropped. Setting an
    # explicit cap trades that guarantee for memory: groups beyond the cap
    # (in key sort order) ARE truncated — callers own the sizing, e.g.
    # when a downstream LIMIT bounds the useful group count.
    max_groups: int | None = None


@dataclasses.dataclass(frozen=True)
class ProjectStep:
    names: tuple[str, ...]


@dataclasses.dataclass(frozen=True)
class SortStep:
    """ORDER BY [+ LIMIT] — lowers to device argsort / top-k."""

    keys: tuple[str, ...]
    descending: tuple[bool, ...] = ()
    limit: int | None = None


@dataclasses.dataclass(frozen=True)
class WindowStep:
    """Ranking window: rank / dense_rank / row_number OVER
    (PARTITION BY partition ORDER BY order_keys).

    Whole-table semantics: the step must see EVERY row of its input at
    once, so it may only appear in programs executed over a
    materialized block (the planner keeps it out of scan pushdown, and
    the DQ lowering splits it into the merged final phase). Lowers to
    one device lexsort + segment scans + inverse-permutation scatter.
    """

    func: str  # rank | dense_rank | row_number
    partition: tuple[str, ...]
    order_keys: tuple[str, ...]
    descending: tuple[bool, ...]
    out_name: str


Step = Union[AssignStep, FilterStep, GroupByStep, ProjectStep, SortStep,
             WindowStep]


@dataclasses.dataclass(frozen=True)
class Program:
    """An ordered SSA program. Hashable: usable as
    the compiled-program cache key (the analog of the reference's
    computation-pattern LRU cache, mkql_computation_pattern_cache.h)."""

    steps: tuple[Step, ...]

    def __post_init__(self):
        object.__setattr__(self, "steps", tuple(self.steps))

    @property
    def group_by(self) -> GroupByStep | None:
        for s in self.steps:
            if isinstance(s, GroupByStep):
                return s
        return None


# ---------------- type inference ----------------

_CMP = {Op.EQ, Op.NE, Op.LT, Op.LE, Op.GT, Op.GE}
_LOGIC = {Op.AND, Op.OR, Op.NOT, Op.XOR}
_PRED = {Op.IS_NULL, Op.IS_NOT_NULL, Op.IN_SET}


def infer_type(
    expr: Expr,
    schema: dtypes.Schema,
    assigned: dict[str, dtypes.LogicalType],
) -> dtypes.LogicalType:
    """Result logical type of an expression (static, pre-lowering)."""
    if isinstance(expr, Col):
        if expr.name in assigned:
            return assigned[expr.name]
        return schema.field(expr.name).type
    if isinstance(expr, Const):
        return expr.type
    if isinstance(expr, DictPredicate):
        return dtypes.BOOL
    if isinstance(expr, DictMap):
        return dtypes.STRING
    if isinstance(expr, UdfCall):
        return expr.out_type
    assert isinstance(expr, Call)
    op = expr.op
    if op in _CMP or op in _LOGIC or op in _PRED:
        return dtypes.BOOL
    if op in (Op.CAST_INT32,):
        return dtypes.INT32
    if op in (Op.CAST_INT64,):
        return dtypes.INT64
    if op in (Op.CAST_FLOAT,):
        return dtypes.FLOAT
    if op in (Op.CAST_DOUBLE, Op.SQRT, Op.EXP, Op.LN, Op.LOG10,
              Op.POW, Op.SIN, Op.COS, Op.TAN, Op.ASIN, Op.ACOS,
              Op.ATAN, Op.SINH, Op.COSH, Op.TANH, Op.ASINH, Op.ACOSH,
              Op.ATANH, Op.ATAN2, Op.HYPOT, Op.CBRT, Op.ERF, Op.LOG2,
              Op.EXP2, Op.TRUNC, Op.RINT, Op.RADIANS, Op.DEGREES):
        return dtypes.DOUBLE
    if op is Op.CAST_INT8:
        return dtypes.INT8
    if op is Op.CAST_INT16:
        return dtypes.INT16
    if op is Op.CAST_UINT64:
        return dtypes.UINT64
    if op is Op.CAST_BOOL:
        return dtypes.BOOL
    if op in (Op.YEAR, Op.MONTH, Op.DAY, Op.HOUR, Op.MINUTE,
              Op.SECOND, Op.DAY_OF_WEEK, Op.DAY_OF_YEAR, Op.WEEK,
              Op.QUARTER):
        return dtypes.INT32
    arg_ts = [infer_type(a, schema, assigned) for a in expr.args]
    if op is Op.SIGN:
        # sign's output (-1/0/1) is NOT in a decimal arg's scaled
        # domain; type it as plain int (physical stays int64)
        return (dtypes.INT64 if arg_ts[0].is_decimal
                else arg_ts[0])
    if op in (Op.NEG, Op.ABS, Op.FLOOR, Op.CEIL, Op.ROUND, Op.BIT_NOT,
              Op.NULLIF, Op.SHIFT_LEFT, Op.SHIFT_RIGHT):
        return arg_ts[0]
    if op in (Op.COALESCE,):
        return arg_ts[0]
    if op is Op.IF:
        return arg_ts[1]
    if op in (Op.ADD, Op.SUB, Op.MUL, Op.DIV, Op.MOD):
        return _numeric_result(op, arg_ts)
    if op is Op.DIV_INT:
        if any(t.is_decimal or t.is_floating for t in arg_ts):
            return dtypes.INT64  # integer division of the values
        return _numeric_result(Op.ADD, arg_ts)
    if op in (Op.BIT_AND, Op.BIT_OR, Op.BIT_XOR):
        return _numeric_result(Op.ADD, arg_ts)
    if op in (Op.GREATEST, Op.LEAST):
        return _numeric_result(Op.ADD, arg_ts)
    if op is Op.DICT_GATHER:
        raise TypeError("DICT_GATHER is lowered internally, not user-facing")
    raise NotImplementedError(f"type inference for {op}")


def _numeric_result(op: Op, ts: list[dtypes.LogicalType]) -> dtypes.LogicalType:
    a, b = ts[0], ts[1]
    if (a.is_decimal and b.is_floating) or (b.is_decimal and a.is_floating):
        # mixed decimal x float: the decimal operand descales to float
        # (compiler _descale_mixed); exact decimal arithmetic is lost
        return dtypes.DOUBLE
    if a.is_decimal or b.is_decimal:
        sa = a.scale if a.is_decimal else 0
        sb = b.scale if b.is_decimal else 0
        if op is Op.MUL:
            return dtypes.decimal(sa + sb)
        if op is Op.DIV:
            return dtypes.DOUBLE
        if op in (Op.ADD, Op.SUB, Op.MOD):
            # operands are rescaled to the larger scale by the compiler
            # (_align_decimals), exact at compile time
            return dtypes.decimal(max(sa, sb))
    if a.is_floating or b.is_floating:
        if a.kind == dtypes.Kind.DOUBLE or b.kind == dtypes.Kind.DOUBLE:
            return dtypes.DOUBLE
        return dtypes.FLOAT
    if op is Op.DIV:
        # integer division stays integral (SQL semantics)
        pass
    # widest integer wins
    order = [
        dtypes.Kind.INT8, dtypes.Kind.UINT8, dtypes.Kind.INT16,
        dtypes.Kind.UINT16, dtypes.Kind.INT32, dtypes.Kind.UINT32,
        dtypes.Kind.DATE, dtypes.Kind.INT64, dtypes.Kind.UINT64,
        dtypes.Kind.TIMESTAMP,
    ]
    ka = order.index(a.kind) if a.kind in order else len(order)
    kb = order.index(b.kind) if b.kind in order else len(order)
    win = a if ka >= kb else b
    if win.kind in (dtypes.Kind.DATE, dtypes.Kind.TIMESTAMP):
        return dtypes.INT64
    return win


def agg_result_type(
    spec: AggSpec,
    schema: dtypes.Schema,
    assigned: dict[str, dtypes.LogicalType],
) -> dtypes.LogicalType:
    if spec.func in (Agg.COUNT, Agg.COUNT_ALL):
        return dtypes.INT64
    t = assigned.get(spec.column) or schema.field(spec.column).type
    if spec.func in (Agg.AVG, Agg.VAR_SAMP, Agg.STDDEV_SAMP):
        return dtypes.DOUBLE
    if spec.func is Agg.SUM:
        if t.is_decimal:
            return t
        if t.is_floating:
            return dtypes.DOUBLE
        return dtypes.INT64
    return t
