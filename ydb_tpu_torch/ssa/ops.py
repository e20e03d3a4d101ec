"""Scalar and aggregate operation vocabulary for SSA programs.

The port's copy of ``ydb_tpu/ssa/ops.py``: the reference's kernel-op enums — simple scalar ops
(ydb/library/arrow_kernels/operations.h: casts, comparison, logic,
arithmetic, string match, math) and aggregate functions
(ydb/core/formats/arrow/program.h `EAggregate`). Each op lowers to a torch
expression over column tensors in ydb_tpu_torch.ssa.kernels.
"""

from __future__ import annotations

import enum


class Op(enum.Enum):
    # comparison (null-propagating)
    EQ = "eq"
    NE = "ne"
    LT = "lt"
    LE = "le"
    GT = "gt"
    GE = "ge"
    # logic (Kleene where nullable)
    AND = "and"
    OR = "or"
    NOT = "not"
    XOR = "xor"
    # arithmetic
    ADD = "add"
    SUB = "sub"
    MUL = "mul"
    DIV = "div"
    MOD = "mod"
    NEG = "neg"
    ABS = "abs"
    DIV_INT = "div_int"  # integer division; /0 -> NULL like DIV
    # bit ops (integer domains)
    BIT_AND = "bit_and"
    BIT_OR = "bit_or"
    BIT_XOR = "bit_xor"
    BIT_NOT = "bit_not"
    SHIFT_LEFT = "shift_left"
    SHIFT_RIGHT = "shift_right"
    # math
    SQRT = "sqrt"
    SIN = "sin"
    COS = "cos"
    TAN = "tan"
    ASIN = "asin"
    ACOS = "acos"
    ATAN = "atan"
    SINH = "sinh"
    COSH = "cosh"
    TANH = "tanh"
    ASINH = "asinh"
    ACOSH = "acosh"
    ATANH = "atanh"
    ATAN2 = "atan2"
    HYPOT = "hypot"
    CBRT = "cbrt"
    ERF = "erf"
    LOG2 = "log2"
    EXP2 = "exp2"
    TRUNC = "trunc"
    RINT = "rint"
    RADIANS = "radians"
    DEGREES = "degrees"
    EXP = "exp"
    LN = "ln"
    LOG10 = "log10"
    FLOOR = "floor"
    CEIL = "ceil"
    ROUND = "round"
    POW = "pow"
    SIGN = "sign"
    GREATEST = "greatest"
    LEAST = "least"
    # null handling
    IS_NULL = "is_null"
    IS_NOT_NULL = "is_not_null"
    COALESCE = "coalesce"
    IF = "if"
    NULLIF = "nullif"  # NULL when equal, else first arg
    # casts
    CAST_INT32 = "cast_int32"
    CAST_INT64 = "cast_int64"
    CAST_FLOAT = "cast_float"
    CAST_DOUBLE = "cast_double"
    CAST_INT8 = "cast_int8"
    CAST_INT16 = "cast_int16"
    CAST_UINT64 = "cast_uint64"
    CAST_BOOL = "cast_bool"
    # date parts (DATE=int32 days / TIMESTAMP=int64 us)
    YEAR = "year"
    MONTH = "month"
    DAY = "day"
    HOUR = "hour"
    MINUTE = "minute"
    SECOND = "second"
    DAY_OF_WEEK = "day_of_week"    # 0 = Sunday (spec convention)
    DAY_OF_YEAR = "day_of_year"    # 1-based
    WEEK = "week"                  # 1 + (doy-1)//7 (simple week-of-year)
    QUARTER = "quarter"
    # string ops on dictionary ids (plan-time resolved masks)
    DICT_GATHER = "dict_gather"   # aux table lookup by id (masks, ranks)
    IN_SET = "in_set"


class Agg(enum.Enum):
    """Aggregate functions (reference: program.h EAggregate — some/count/
    min/max/sum + numrows; avg decomposes into sum+count)."""

    COUNT = "count"          # non-null count
    COUNT_ALL = "count_all"  # row count (NumRows)
    SUM = "sum"
    MIN = "min"
    MAX = "max"
    AVG = "avg"
    SOME = "some"            # any value (first non-null)
    # sample variance/stddev (TPC-DS q17/q39 stddev_samp): NULL for
    # groups of fewer than two non-null values. Two-phase split
    # decomposes them into SUM(x) + SUM(x^2) + COUNT partials, so the
    # distributed merge stays linear.
    VAR_SAMP = "var_samp"
    STDDEV_SAMP = "stddev_samp"


#: Merge rule applied when combining partial aggregate states between
#: shards (reference two-phase agg: BlockCombineHashed partial states merged
#: by BlockMergeFinalizeHashed, mkql_block_agg.cpp). SUM-like states psum
#: over the mesh; MIN/MAX take elementwise extremes.
PARTIAL_MERGE = {
    Agg.COUNT: Agg.SUM,
    Agg.COUNT_ALL: Agg.SUM,
    Agg.SUM: Agg.SUM,
    Agg.MIN: Agg.MIN,
    Agg.MAX: Agg.MAX,
    Agg.SOME: Agg.SOME,
    # VAR/STDDEV never appear in PARTIAL programs (twophase.split
    # decomposes them into SUM/SUM/COUNT states first); no entry.
}
