"""SSA program verifier: a typed static checker run before lowering (the
port's copy of ``ydb_tpu/analysis/verify.py``).

The reference validates every serialized scan program before executing
it (TProgramContainer::Init, ydb/core/tx/program/program.cpp:553;
column resolution + kernel registry checks in
formats/arrow/program.h). The compiler lowers step lists straight into
torch operations, where a malformed program surfaces as an opaque
error deep inside ``ssa/compiler.py``. This verifier walks the step
list with a typed symbol table — exactly the scope the run-time
``env`` dict will hold — and emits structured ``Diagnostic`` records
(step index, expression path, error code, fix hint) instead.

It is the mandatory precondition of ``ssa.compiler.compile_program``
and of every scan/transform entry in the executors: no program reaches
the kernel layer unverified ("a typed plan checker in front of the
tensor compiler keeps the kernel layer simple" — the Tensor Query
Processor argument, PAPERS.md).

Beyond types, the verifier infers *nullability* through the program
(the compiler uses the result to type its output schema), and rejects
ranking-window partition/order keys that may be NULL: the window
lowering sorts raw physical values, so a NULL key would rank by the
stale bits under the null — silently wrong results rather than an
error (ADVICE round 5, ssa/compiler.py:321).

Division/modulo results are typed nullable unless the divisor is a
provably nonzero literal (a zero divisor NULLs the row at runtime),
so V005 also catches window keys derived from divisions. The scan
executor types its RESULT schema from the original program's analysis
— keyed AVG over a non-null input stays non-null even though the
two-phase rewrite computes it via a division fixup.

Error codes (see the reference's ydb_tpu/analysis/README.md):
  V001 unknown-column          expression references a column not in scope
  V002 filter-not-boolean      FilterStep predicate is not BOOL
  V003 agg-input-mismatch      AggSpec input column/dtype unusable
  V004 dead-projection         ProjectStep names a column not in scope
  V005 window-key-nullable     window partition/order key may be NULL
  V006 group-capacity          GroupByStep.max_groups is not positive
  V007 expr-type               expression cannot be typed (bad operands)
  V008 sort-desc-arity         descending flags do not match sort keys
  V009 unknown-window-function window function is not rank-family
  V010 duplicate-output-column projection/group-by emits one output
                               name twice (later write would silently
                               shadow the earlier column)
"""

from __future__ import annotations

import dataclasses

from ydb_tpu_torch import dtypes
from ydb_tpu_torch.analysis.diagnostics import Diagnostic, VerificationError
from ydb_tpu_torch.ssa.ops import Agg, Op
from ydb_tpu_torch.ssa.program import (
    AggSpec,
    AssignStep,
    Call,
    Col,
    Const,
    DictMap,
    DictPredicate,
    FilterStep,
    GroupByStep,
    Program,
    ProjectStep,
    SortStep,
    UdfCall,
    WindowStep,
    agg_result_type,
    infer_type,
)

_EMPTY_SCHEMA = dtypes.Schema(())

#: Aggregates whose input must be orderable/summable numerics — a STRING
#: input (physically a dictionary id) would silently aggregate ids.
_NUMERIC_AGGS = (Agg.SUM, Agg.AVG, Agg.VAR_SAMP, Agg.STDDEV_SAMP)

_WINDOW_FUNCS = ("rank", "dense_rank", "row_number")

#: Ops whose runtime validity collapses to "all args valid" — plus the
#: documented zero-divisor approximation for DIV/MOD/DIV_INT.
_NEVER_NULL_OPS = (Op.IS_NULL, Op.IS_NOT_NULL)


@dataclasses.dataclass
class ProgramAnalysis:
    """Verification result: findings plus the derived output scope."""

    diagnostics: list
    out_names: tuple
    out_types: dict
    out_nullable: dict

    @property
    def errors(self) -> list:
        return [d for d in self.diagnostics if d.severity == "error"]

    def raise_if_errors(self) -> "ProgramAnalysis":
        if self.errors:
            raise VerificationError(self.errors)
        return self


def infer_nullable(expr, nullable: dict) -> bool:
    """May ``expr`` evaluate to NULL, given per-column nullability?

    Mirrors the validity arithmetic of ssa/compiler lowering (Kleene
    AND of argument validities for most ops), with the zero-divisor
    approximation documented in the module docstring. Unknown columns
    count as non-null — the scope walk reports those separately.
    """
    if isinstance(expr, Col):
        return nullable.get(expr.name, False)
    if isinstance(expr, Const):
        return expr.value is None
    if isinstance(expr, (DictPredicate, DictMap)):
        return nullable.get(expr.column, False)
    if isinstance(expr, UdfCall):
        return any(infer_nullable(a, nullable) for a in expr.args)
    if isinstance(expr, Call):
        op = expr.op
        if op in _NEVER_NULL_OPS:
            return False
        if op is Op.NULLIF:  # produces NULL on equality by design
            return True
        if op is Op.COALESCE:
            return all(infer_nullable(a, nullable) for a in expr.args)
        if op in (Op.DIV, Op.MOD, Op.DIV_INT):
            # a zero divisor NULLs the row at runtime regardless of
            # operand nullability; only a provably nonzero literal
            # divisor is safe
            div = expr.args[1] if len(expr.args) > 1 else None
            if not (isinstance(div, Const) and div.value is not None
                    and div.value != 0):
                return True
        return any(infer_nullable(a, nullable) for a in expr.args)
    return True  # unknown node kind: assume the worst


class _Verifier:
    def __init__(self, schema: dtypes.Schema):
        self.diags: list = []
        self.types: dict = {f.name: f.type for f in schema.fields}
        self.nullable: dict = {f.name: f.nullable for f in schema.fields}
        self.names: list = list(schema.names)

    def diag(self, code, name, message, step=None, path="", hint="",
             severity="error"):
        self.diags.append(Diagnostic(
            code=code, name=name, message=message, step=step, path=path,
            hint=hint, severity=severity))

    # ---- expressions ----

    def expr(self, e, step: int, path: str):
        """Return (LogicalType | None, nullable); None = poisoned (a
        diagnostic was already emitted for this subtree)."""
        if isinstance(e, Col):
            if e.name not in self.types:
                self.diag(
                    "V001", "unknown-column",
                    f"column {e.name!r} is not in scope"
                    f" (live columns: {sorted(self.types)})",
                    step, path,
                    hint="assign it earlier or fix the column name")
                return None, False
            return self.types[e.name], self.nullable[e.name]
        if isinstance(e, Const):
            return e.type, e.value is None
        if isinstance(e, (DictPredicate, DictMap)):
            if e.column not in self.types:
                self.diag(
                    "V001", "unknown-column",
                    f"column {e.column!r} is not in scope", step, path)
                return None, False
            if not self.types[e.column].is_string:
                self.diag(
                    "V007", "expr-type",
                    f"dictionary {type(e).__name__} on non-string column"
                    f" {e.column!r} ({self.types[e.column]})", step, path)
                return None, False
            null = self.nullable[e.column]
            if isinstance(e, DictPredicate):
                return dtypes.BOOL, null
            return (dtypes.INT32 if e.kind in ("xrank", "strlen")
                    else dtypes.STRING), null
        if isinstance(e, UdfCall):
            null = False
            for j, a in enumerate(e.args):
                _, n = self.expr(a, step, f"{path}.args[{j}]")
                null = null or n
            return e.out_type, null
        if isinstance(e, Call):
            return self._call(e, step, path)
        self.diag("V007", "expr-type",
                  f"unknown expression node {type(e).__name__}", step, path)
        return None, False

    def _call(self, e: Call, step: int, path: str):
        arg_ts = []
        for j, a in enumerate(e.args):
            t, _ = self.expr(a, step, f"{path}.args[{j}]")
            arg_ts.append(t)
        null = infer_nullable(e, self.nullable)
        if any(t is None for t in arg_ts):
            return None, null  # sub-diagnostic already emitted
        op = e.op
        if op in (Op.HOUR, Op.MINUTE, Op.SECOND) and (
                not arg_ts or arg_ts[0].kind != dtypes.Kind.TIMESTAMP):
            self.diag(
                "V007", "expr-type",
                f"{op.name} needs a timestamp operand, got"
                f" {arg_ts[0] if arg_ts else 'nothing'}", step, path,
                hint="CAST or use a timestamp column")
            return None, null
        if op is Op.IN_SET and not all(
                isinstance(a, Const) for a in e.args[1:]):
            self.diag("V007", "expr-type",
                      "IN_SET members must be constants", step, path)
            return None, null
        try:
            t = infer_type(e, _EMPTY_SCHEMA, self.types)
        except (TypeError, KeyError, IndexError, NotImplementedError) as ex:
            self.diag("V007", "expr-type",
                      f"cannot type {op.name} call: {ex}", step, path)
            return None, null
        return t, null

    # ---- steps ----

    def step(self, i: int, s) -> None:
        if isinstance(s, AssignStep):
            t, null = self.expr(s.expr, i, f"steps[{i}].expr")
            self.types[s.name] = t if t is not None else dtypes.INT64
            self.nullable[s.name] = null
            if s.name not in self.names:
                self.names.append(s.name)
        elif isinstance(s, FilterStep):
            t, _ = self.expr(s.expr, i, f"steps[{i}].expr")
            if t is not None and t.kind != dtypes.Kind.BOOL:
                self.diag(
                    "V002", "filter-not-boolean",
                    f"filter predicate must be BOOL, got {t}", i,
                    f"steps[{i}].expr",
                    hint="compare the expression instead of filtering"
                         " on its raw value")
        elif isinstance(s, GroupByStep):
            self._group_by(i, s)
        elif isinstance(s, ProjectStep):
            kept: list = []
            for j, n in enumerate(s.names):
                if n in kept:
                    self.diag(
                        "V010", "duplicate-output-column",
                        f"projection lists column {n!r} twice — the"
                        " output would carry one physical column under"
                        " a repeated name", i, f"steps[{i}].names[{j}]",
                        hint="drop the repeated name or alias it via"
                             " an assign first")
                    continue
                if n not in self.types:
                    self.diag(
                        "V004", "dead-projection",
                        f"projection names column {n!r} which is not in"
                        f" scope (live columns: {sorted(self.types)})", i,
                        f"steps[{i}].names[{j}]",
                        hint="assign the column before projecting it")
                    self.types[n] = dtypes.INT64
                    self.nullable[n] = False
                kept.append(n)
            self.names = kept
            self.types = {n: self.types[n] for n in kept}
            self.nullable = {n: self.nullable[n] for n in kept}
        elif isinstance(s, SortStep):
            for j, k in enumerate(s.keys):
                self.expr(Col(k), i, f"steps[{i}].keys[{j}]")
            if s.descending and len(s.descending) != len(s.keys):
                self.diag(
                    "V008", "sort-desc-arity",
                    f"{len(s.descending)} descending flags for"
                    f" {len(s.keys)} sort keys", i, f"steps[{i}]")
        elif isinstance(s, WindowStep):
            self._window(i, s)
        else:
            self.diag("V007", "expr-type",
                      f"unknown step kind {type(s).__name__}", i,
                      f"steps[{i}]")

    def _group_by(self, i: int, s: GroupByStep) -> None:
        if s.max_groups is not None and s.max_groups <= 0:
            self.diag(
                "V006", "group-capacity",
                f"max_groups must be positive, got {s.max_groups}", i,
                f"steps[{i}].max_groups",
                hint="omit max_groups to size groups to the block")
        out_types: dict = {}
        out_nullable: dict = {}
        seen: set = set()
        for j, k in enumerate(s.keys):
            if k in seen:
                self.diag(
                    "V010", "duplicate-output-column",
                    f"group-by key {k!r} appears twice", i,
                    f"steps[{i}].keys[{j}]",
                    hint="drop the repeated key")
            seen.add(k)
            t, null = self.expr(Col(k), i, f"steps[{i}].keys[{j}]")
            out_types[k] = t if t is not None else dtypes.INT64
            out_nullable[k] = null
        keyed = bool(s.keys)
        for j, spec in enumerate(s.aggs):
            path = f"steps[{i}].aggs[{j}]"
            if spec.out_name in seen:
                self.diag(
                    "V010", "duplicate-output-column",
                    f"aggregate output {spec.out_name!r} collides with"
                    " an earlier key or aggregate — the later column"
                    " would silently shadow the earlier one", i, path,
                    hint="rename the aggregate output")
            seen.add(spec.out_name)
            out_types[spec.out_name] = dtypes.INT64
            out_nullable[spec.out_name] = False
            if spec.func is Agg.COUNT_ALL:
                continue
            if spec.column is None:
                self.diag(
                    "V003", "agg-input-mismatch",
                    f"{spec.func.name} needs an input column"
                    " (only COUNT_ALL takes none)", i, path)
                continue
            t, null = self.expr(Col(spec.column), i, f"{path}.column")
            if t is None:
                continue
            if spec.func in _NUMERIC_AGGS and t.is_string:
                self.diag(
                    "V003", "agg-input-mismatch",
                    f"{spec.func.name} over string column"
                    f" {spec.column!r} would aggregate dictionary ids,"
                    " not values", i, path,
                    hint="use MIN/MAX/COUNT for strings")
                continue
            try:
                out_types[spec.out_name] = agg_result_type(
                    spec, _EMPTY_SCHEMA, self.types)
            except (TypeError, KeyError, NotImplementedError) as ex:
                self.diag("V003", "agg-input-mismatch",
                          f"cannot type {spec.func.name}: {ex}", i, path)
                continue
            if spec.func in (Agg.COUNT, Agg.COUNT_ALL):
                out_nullable[spec.out_name] = False
            elif spec.func in (Agg.VAR_SAMP, Agg.STDDEV_SAMP):
                # NULL for single-row groups (n-1 denominator)
                out_nullable[spec.out_name] = True
            else:
                # a keyed group exists because >= 1 live row carries the
                # key, so a non-null input forces a non-null state; a
                # keyless aggregate over zero rows is NULL (except COUNT)
                out_nullable[spec.out_name] = null or not keyed
        self.names = list(s.keys) + [a.out_name for a in s.aggs]
        self.types = out_types
        self.nullable = out_nullable

    def _window(self, i: int, s: WindowStep) -> None:
        if s.func not in _WINDOW_FUNCS:
            self.diag(
                "V009", "unknown-window-function",
                f"window function {s.func!r} is not supported"
                f" (supported: {', '.join(_WINDOW_FUNCS)})", i,
                f"steps[{i}].func")
        if s.descending and len(s.descending) != len(s.order_keys):
            self.diag(
                "V008", "sort-desc-arity",
                f"{len(s.descending)} descending flags for"
                f" {len(s.order_keys)} window order keys", i,
                f"steps[{i}]")
        for role, keys in (("partition", s.partition),
                           ("order", s.order_keys)):
            for j, k in enumerate(keys):
                path = f"steps[{i}].{role}[{j}]"
                t, null = self.expr(Col(k), i, path)
                if t is None:
                    continue
                if null:
                    self.diag(
                        "V005", "window-key-nullable",
                        f"window {role} key {k!r} may be NULL; the"
                        " ranking lowering sorts raw physical values,"
                        " so NULL keys would rank by stale bits"
                        " instead of grouping as NULL", i, path,
                        hint="COALESCE the key or filter NULLs ahead"
                             " of the window")
        self.types[s.out_name] = dtypes.INT64
        self.nullable[s.out_name] = False
        if s.out_name not in self.names:
            self.names.append(s.out_name)


def analyze_program(program: Program,
                    schema: dtypes.Schema) -> ProgramAnalysis:
    """Walk the program statically; never raises on malformed input —
    every defect becomes a ``Diagnostic``."""
    v = _Verifier(schema)
    for i, s in enumerate(program.steps):
        v.step(i, s)
    return ProgramAnalysis(
        diagnostics=v.diags,
        out_names=tuple(v.names),
        out_types=dict(v.types),
        out_nullable=dict(v.nullable),
    )


def verify_program(program: Program, schema: dtypes.Schema) -> list:
    """Diagnostics only (empty list = program is well-formed)."""
    return analyze_program(program, schema).diagnostics


def check_program(program: Program,
                  schema: dtypes.Schema) -> ProgramAnalysis:
    """Verify and raise ``VerificationError`` (a PlanError) on any
    error-severity finding; returns the analysis otherwise so callers
    can reuse the inferred output nullability."""
    return analyze_program(program, schema).raise_if_errors()
